"""Classification head (reference ``models/Head.py``)."""

import torch
from torch import nn

from care_tpu_torch.models.common import dense, unsupported


class NaiveHead(nn.Module):
    """One bias-free linear map to the vocab (reference ``Head.py:26-32``).
    ``tgt_word_prj.weight`` [V, H] is what the fused beam head streams."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.tgt_word_prj = dense(opt["dim_hidden"], opt["vocab_size"],
                                  generator, bias=False)

    def forward(self, hidden_states):
        return self.tgt_word_prj(hidden_states)


def get_cls_head(opt: dict, generator: torch.Generator) -> nn.Module:
    if opt["cls_head"] != "NaiveHead":
        raise unsupported("cls_head", opt["cls_head"])
    return NaiveHead(opt, generator)
