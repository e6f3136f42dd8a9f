"""Classification heads (reference ``models/Head.py``)."""

import torch
from torch import nn

from care_tpu_torch.models.common import Dropout, dense
from care_tpu_torch.parallel import tensor_parallel as tp


class NaiveHead(nn.Module):
    """One bias-free linear map to the vocab (reference ``Head.py:26-32``).
    ``tgt_word_prj.weight`` [V, H] is what the fused beam head streams. On
    a mesh's model axis it holds this process's vocab rows [V/tp, H], and
    the logits come back whole (gathered over the model group), so that
    every consumer of a logits row (the cross-entropy, its word accuracy,
    the dense decodes) reads it as without the mesh."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.tgt_word_prj = dense(opt["dim_hidden"], opt["vocab_size"],
                                  generator, bias=False)

    def forward(self, hidden_states):
        return tp.column_whole(self.tgt_word_prj, hidden_states)


class MLPHead(nn.Module):
    """Dense + tanh + dropout + a biased projection to the vocab
    (reference ``Head.py:35-49``). Neither the fused beam head nor the
    fused cross-entropy takes it: both stream a bias-free projection of the
    decoder's hidden state, as the JAX package rules."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.dense = dense(opt["dim_hidden"], opt["dim_hidden"], generator)
        self.dropout = Dropout(opt["hidden_dropout_prob"])
        self.tgt_word_prj = dense(opt["dim_hidden"], opt["vocab_size"],
                                  generator)

    def forward(self, hidden_states):
        return tp.column_whole(self.tgt_word_prj, self.dropout(torch.tanh(
            self.dense(hidden_states))))


HEADS = {"NaiveHead": NaiveHead, "MLPHead": MLPHead}


def get_cls_head(opt: dict, generator: torch.Generator) -> nn.Module:
    if opt["cls_head"] not in HEADS:
        raise ValueError(f"unknown cls_head `{opt['cls_head']}`")
    return HEADS[opt["cls_head"]](opt, generator)
