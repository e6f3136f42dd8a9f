"""Multi-stream feature encoder.

Port of ``care_tpu/models/encoders.py:MultipleStreams`` (reference
``models/Encoder.py``) with the ``Embedder`` streams the flagship uses: one
Linear + LN + Dropout per modality character, ``temporal_concat`` fusion,
and the per-component modality views (the decoder and the concept predictor
may each see a subset of the streams).
"""

from typing import Any, Dict, List

import torch
from torch import nn

from care_tpu_torch.models.common import (Dropout, LayerNorm, dense,
                                          unsupported)


class LinearLNDrop(nn.Module):
    def __init__(self, dim_in: int, dim_out: int, dropout: float, eps: float,
                 generator: torch.Generator):
        super().__init__()
        self.linear = dense(dim_in, dim_out, generator)
        self.ln = LayerNorm(dim_out, eps=eps)
        self.dropout = Dropout(dropout)

    def forward(self, x):
        return self.dropout(self.ln(self.linear(x)))


def fuse(encoder_hidden_states: List[torch.Tensor]) -> torch.Tensor:
    """``temporal_concat`` fusion (reference ``Encoder.py:140-153``)."""
    return torch.cat(encoder_hidden_states, dim=1)


class MultipleStreams(nn.Module):
    """One ``Encoder_<C>`` stream per dense modality character + fusion +
    component views."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt["encoder"] != "Embedder":
            raise unsupported("encoder", opt["encoder"])
        if opt.get("fusion", "temporal_concat") != "temporal_concat":
            raise unsupported("fusion", opt["fusion"])
        if "t" in opt["modality"]:
            raise unsupported("modality", opt["modality"])
        self.opt = opt
        self.dense_modality = opt["modality"].lower()
        self.stream_names = []
        for char in self.dense_modality:
            name = f"Encoder_{char.upper()}"
            self.add_module(name, LinearLNDrop(
                opt["dim_" + char], opt.get("dim_hidden", 512),
                opt.get("encoder_dropout_prob", 0.5), opt["layer_norm_eps"],
                generator))
            self.stream_names.append(name)

    def _component_view(self, per_modality: Dict[str, list],
                        component_modality: str) -> Dict[str, Any]:
        keep = [i for i, c in enumerate(self.dense_modality)
                if c in component_modality]
        view = {k: [v[i] for i in keep] for k, v in per_modality.items()}
        view["encoder_hidden_states"] = fuse(view["encoder_hidden_states"])
        return view

    def forward(self, input_feats: List[torch.Tensor]) -> Dict[str, Any]:
        if len(input_feats) != len(self.stream_names):
            raise ValueError(f"{len(input_feats)} feature streams for "
                             f"modality `{self.dense_modality}`")
        states = [getattr(self, name)(f)
                  for name, f in zip(self.stream_names, input_feats)]
        per_modality = {"encoder_hidden_states": states,
                        "mean_encoder_hidden_states":
                            [s.mean(dim=1) for s in states]}
        data: Dict[str, Any] = {k: list(v) for k, v in per_modality.items()}
        for key_name, comp_mod in [
                ("inputs_for_predictor", self.opt.get("modality_for_predictor")),
                ("inputs_for_decoder", self.opt.get("modality_for_decoder"))]:
            comp_mod = (comp_mod or "").replace("t", "")
            if comp_mod and comp_mod != self.dense_modality:
                data[key_name] = self._component_view(per_modality, comp_mod)
        data["encoder_hidden_states"] = fuse(states)
        return data
