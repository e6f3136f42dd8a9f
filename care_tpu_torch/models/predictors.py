"""Concept detection (MCD) and the G-LSG semantic container.

Port of ``care_tpu/models/predictors.py`` (reference
``models/Predictor/pred_attribute.py``): the noisy-OR multiple-instance
concept head, and the SemanticContainer that turns the concept
distribution into the LSG concept-slot embeddings (top-k concepts) and the
GSG latent-topic vector.
"""

from typing import Any, Dict

import torch
from torch import nn

from care_tpu_torch.models.common import dense, unsupported
from care_tpu_torch.models.embeddings import NaiveEmbeddings
from care_tpu_torch.ops.topk import top_k


def prepare_merged_probs(scores):
    """Noisy-OR MIL merge over the instance axis: 1 - prod_t (1 - sigmoid(s_t)).

    scores: [bsz, seq_len, n_attributes]. Mirrors reference
    ``pred_attribute.py:17-46`` including the 1e-12 log clamp. Returns
    (merged [bsz, n_attributes], avg_prob [bsz]).
    """
    if scores.dim() != 3:
        raise ValueError("scores must be [bsz, seq_len, n_attributes]")
    probs = torch.sigmoid(scores.float())
    raw = torch.log(torch.clamp(1.0 - probs, 1e-12, 1.0))
    merged = 1.0 - torch.exp(raw.sum(dim=1))
    return merged, probs.mean(dim=(1, 2))


class AttributePrjHeads(nn.Module):
    """The shared per-flag concept projection ``prj``."""

    def __init__(self, opt: dict, dim_in: int, generator: torch.Generator):
        super().__init__()
        flags = opt["attribute_prediction_flags"]
        if len(flags) != 1 and not opt.get("attribute_prediction_share_prj"):
            raise unsupported("attribute_prediction_flags", flags)
        self.prj = dense(dim_in, opt["attribute_prediction_k"], generator)

    def forward(self, feats):
        return self.prj(feats)


class PredictorAttribute(nn.Module):
    """MCD concept detector (reference ``pred_attribute.py:49-131``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt["attribute_prediction_flags"] != "V":
            raise unsupported("attribute_prediction_flags",
                              opt["attribute_prediction_flags"])
        self.opt = opt
        self.channel_concat = opt.get("attribute_prediction_channel_concat",
                                      False)
        self.mean_pooling = opt.get("attribute_prediction_mean_pooling", False)
        modality = (opt.get("modality_for_predictor")
                    or opt["modality"]).replace("t", "")
        self.n_modality = len(modality)
        dim_in = opt["dim_hidden"] * (self.n_modality if self.channel_concat
                                      else 1)
        self.attribute_heads = AttributePrjHeads(opt, dim_in, generator)

    def forward(self, encoder_hidden_states, mean_encoder_hidden_states=None,
                **kwargs) -> Dict[str, Any]:
        if self.training and self.opt.get(
                "attribute_prediction_sparse_sampling"):
            raise unsupported("attribute_prediction_sparse_sampling in "
                              "training")
        hidden_states = encoder_hidden_states
        if self.channel_concat and self.mean_pooling:
            hidden_states = torch.cat(mean_encoder_hidden_states,
                                      dim=-1)[:, None, :]
        elif self.channel_concat:
            chunks = hidden_states.chunk(self.n_modality, dim=1)
            hidden_states = torch.cat(chunks, dim=-1)
        elif self.mean_pooling:
            hidden_states = torch.stack(mean_encoder_hidden_states, dim=1)
        preds_attr, avg_prob_attr = prepare_merged_probs(
            self.attribute_heads(hidden_states))
        return {"preds_attr": preds_attr, "avg_prob_attr": avg_prob_attr}


class SemanticContainer(nn.Module):
    """G-LSG bridge (reference ``pred_attribute.py:239-289``):

    * LSG: the top-k concept ids -> ``semantic_labels``, embedded by
      ``attr_embs`` -> ``semantic_embs``;
    * GSG: ``semantic2hidden`` of the (detached) concept distribution ->
      ``semantic_hidden_states``.
    """

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt.get("logits"):
            raise unsupported("logits", opt["logits"])
        self.topk = opt["use_attr_topk"]
        use_attr_type = opt.get("use_attr_type") or ""
        if "L0" not in (opt.get("use_attr_flags", "") or ""):
            self.attr_embs = NaiveEmbeddings(
                n_words=opt["attribute_prediction_k"],
                n_positions=opt["use_attr_topk"],
                dim_hidden=opt["dim_hidden"],
                layer_norm_eps=opt["layer_norm_eps"],
                hidden_dropout_prob=opt["hidden_dropout_prob"],
                generator=generator,
                has_dropout=not opt.get("attr_embs_no_dropout", False))
        else:
            self.attr_embs = None
        if "emb" in use_attr_type:
            self.semantic2hidden = dense(
                opt["attribute_prediction_k"], opt["dim_hidden"], generator,
                bias="pp_emb" in use_attr_type)
        else:
            self.semantic2hidden = None

    def forward(self, encoder_hidden_states=None, preds_attr=None,
                **kwargs) -> Dict[str, Any]:
        _, semantic_labels = top_k(preds_attr, self.topk)
        semantic_embs = (None if self.attr_embs is None
                         else self.attr_embs(semantic_labels))
        semantic_hidden_states = (None if self.semantic2hidden is None
                                  else self.semantic2hidden(
                                      preds_attr.detach()))
        return {"semantic_embs": semantic_embs,
                "semantic_labels": semantic_labels,
                "semantic_hidden_states": semantic_hidden_states}


class Predictor(nn.Module):
    """Chained container: each net's outputs feed the next
    (reference ``Predictor/base.py:6-15``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.net_names = []
        for crit in opt["crits"]:
            if crit == "lang":
                continue
            if crit != "attribute":
                raise unsupported("crits", opt["crits"])
            self.add_module("Predictor_attribute",
                            PredictorAttribute(opt, generator))
            self.net_names.append("Predictor_attribute")
        for name in opt.get("predictors_to_be_added", []) or []:
            if name != "SemanticContainer":
                raise unsupported("predictors_to_be_added", name)
            self.add_module(name, SemanticContainer(opt, generator))
            self.net_names.append(name)

    def forward(self, encoder_hidden_states, **kwargs) -> Dict[str, Any]:
        results: Dict[str, Any] = {}
        for name in self.net_names:
            results.update(getattr(self, name)(encoder_hidden_states,
                                               **{**kwargs, **results}))
        return results


def has_predictor(opt: dict) -> bool:
    crits = [c for c in opt["crits"] if c != "lang"]
    return bool(crits) or bool(opt.get("predictors_to_be_added"))
