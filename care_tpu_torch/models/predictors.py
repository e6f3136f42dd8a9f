"""Concept detection (MCD), the G-LSG semantic container and the text
post-processing of the decoder-side concept heads.

Port of ``care_tpu/models/predictors.py`` (reference
``models/Predictor/pred_attribute.py``): the noisy-OR multiple-instance
concept head with one projection per flag (or one shared), the train-time
sparse frame sampling, the SemanticContainer that turns the concept
distribution (or given ``semantic_logits``) into the LSG concept-slot
embeddings (top-k concepts) and the GSG latent-topic vector, the
``TAP_pos`` / ``TAP_ln`` post-processing of text embeddings, and the
length predictor of NAR decoding.
"""

from typing import Any, Dict

import torch
from torch import nn

from care_tpu_torch.models.common import Dropout, LayerNorm, dense
from care_tpu_torch.models.embeddings import NaiveEmbeddings
from care_tpu_torch.ops.topk import top_k
from care_tpu_torch.parallel import tensor_parallel as tp


def prepare_merged_probs(scores, mask=None):
    """Noisy-OR MIL merge over the instance axis: 1 - prod_t (1 - sigmoid(s_t)).

    scores: [bsz, seq_len, n_attributes]; ``mask`` [bsz, seq_len], True at
    the positions left out. Mirrors reference ``pred_attribute.py:17-46``
    including the 1e-12 log clamp. Returns (merged [bsz, n_attributes],
    avg_prob [bsz]).
    """
    if scores.dim() != 3:
        raise ValueError("scores must be [bsz, seq_len, n_attributes]")
    probs = torch.sigmoid(scores.float())
    raw = torch.log(torch.clamp(1.0 - probs, 1e-12, 1.0))
    if mask is None:
        avg_prob = probs.mean(dim=(1, 2))
    else:
        keep = (~mask).float()
        raw = raw * keep[:, :, None]
        avg_prob = ((probs.mean(dim=2) * keep).sum(dim=1)
                    / torch.clamp_min(keep.sum(dim=1), 1.0))
    return 1.0 - torch.exp(raw.sum(dim=1)), avg_prob


class AttributePrjHeads(nn.Module):
    """The per-flag concept projections, shared between the detector (flag
    ``V``) and the decoder-side concept losses (reference ``prj`` sharing,
    ``pred_attribute.py:61-70``): one ``prj`` when
    ``attribute_prediction_share_prj`` or a single flag, else one
    ``prj_<flag>`` each. ``V`` reads the encoder side (``dim_in_v`` wide),
    every other flag a ``dim_hidden``-wide text-side stream. On a mesh's
    model axis each projection holds this process's block of the concepts
    and the scores come back whole, before the noisy-OR merge and the
    top-k slot selection, which need all concepts."""

    def __init__(self, opt: dict, dim_in_v: int, generator: torch.Generator):
        super().__init__()
        self.flags = opt["attribute_prediction_flags"]
        k = opt["attribute_prediction_k"]
        dim = opt["dim_hidden"]
        self.shared = (opt.get("attribute_prediction_share_prj", False)
                       or len(self.flags) == 1)
        if self.shared:
            self.prj = dense(dim_in_v if "V" in self.flags else dim, k,
                             generator)
        else:
            for f in self.flags:
                self.add_module(f"prj_{f}", dense(
                    dim_in_v if f == "V" else dim, k, generator))

    def by_flag(self, feats, flag: str):
        return tp.column_whole(self.prj if self.shared else getattr(
            self, f"prj_{flag}"), feats)


class PredictorAttribute(nn.Module):
    """MCD concept detector (reference ``pred_attribute.py:49-131``).

    With ``attribute_prediction_sparse_sampling`` a training forward keeps
    a random share of the instances of each sample: a ratio r ~ U(0, 1),
    then the ceil(r * seq_len) instances of lowest uniform draw, as the JAX
    package re-expresses the reference's gather-then-mask. The draws come
    from ``generator`` (set with the dropout's, ``set_dropout_generator``);
    the two frameworks' streams differ, the distribution is the same.
    """

    draws_in_training = True

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.opt = opt
        self.flags = opt["attribute_prediction_flags"]
        self.channel_concat = opt.get("attribute_prediction_channel_concat",
                                      False)
        self.mean_pooling = opt.get("attribute_prediction_mean_pooling", False)
        modality = (opt.get("modality_for_predictor")
                    or opt["modality"]).replace("t", "")
        self.n_modality = len(modality)
        dim_in = opt["dim_hidden"] * (self.n_modality if self.channel_concat
                                      else 1)
        self.attribute_heads = AttributePrjHeads(opt, dim_in, generator)
        self.sparse_sampling = opt.get("attribute_prediction_sparse_sampling",
                                       False)
        self.generator = None

    def sampling_mask(self, bsz: int, seq_len: int, device):
        """[bsz, seq_len], True at the instances a training forward leaves
        out."""
        ratio = torch.rand((bsz,), generator=self.generator, device=device)
        num = torch.ceil(seq_len * ratio).long()
        u = torch.rand((bsz, seq_len), generator=self.generator,
                       device=device)
        rank = torch.argsort(torch.argsort(u, dim=1), dim=1)
        return rank >= num[:, None]

    def forward(self, encoder_hidden_states, mean_encoder_hidden_states=None,
                **kwargs) -> Dict[str, Any]:
        if isinstance(encoder_hidden_states, (list, tuple)):
            encoder_hidden_states = torch.cat(encoder_hidden_states, dim=1)
        hidden_states = encoder_hidden_states
        if self.channel_concat and self.mean_pooling:
            hidden_states = torch.cat(mean_encoder_hidden_states,
                                      dim=-1)[:, None, :]
        elif self.channel_concat:
            if hidden_states.shape[1] % self.n_modality:
                raise ValueError("streams of unequal length cannot be "
                                 "concatenated along the channels")
            chunks = hidden_states.chunk(self.n_modality, dim=1)
            hidden_states = torch.cat(chunks, dim=-1)
        elif self.mean_pooling:
            hidden_states = torch.stack(mean_encoder_hidden_states, dim=1)
        if "V" not in self.flags:
            return {"preds_attr": None, "avg_prob_attr": None}
        mask = None
        if self.training and self.sparse_sampling:
            mask = self.sampling_mask(hidden_states.shape[0],
                                      hidden_states.shape[1],
                                      hidden_states.device)
        preds_attr, avg_prob_attr = prepare_merged_probs(
            self.attribute_heads.by_flag(hidden_states, "V"), mask)
        return {"preds_attr": preds_attr, "avg_prob_attr": avg_prob_attr}

    def project_with_flag(self, feats, flag: str):
        """The flag's projection, for the decoder-side concept losses."""
        return self.attribute_heads.by_flag(feats, flag)


class TextPostProcesser(nn.Module):
    """Learned positions (``TAP_pos``: ``PE`` [max_len, D], drawn from
    N(0, 0.02)) and LN (``TAP_ln``: ``LN``) + dropout on text-side
    embeddings (reference ``pred_attribute.py:213-236``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.PE = None
        if opt.get("TAP_pos", False):
            table = torch.empty(opt["max_len"], opt["dim_hidden"])
            nn.init.normal_(table, std=0.02, generator=generator)
            self.PE = nn.Parameter(table)
        self.LN = (LayerNorm(opt["dim_hidden"], eps=opt["layer_norm_eps"])
                   if opt.get("TAP_ln", False) else None)
        self.dropout = Dropout(opt["hidden_dropout_prob"])

    def forward(self, word_embeddings):
        if self.PE is not None:
            word_embeddings = (word_embeddings
                               + self.PE[None, :word_embeddings.shape[1]])
        if self.LN is not None:
            word_embeddings = self.LN(word_embeddings)
        return self.dropout(word_embeddings)


class SemanticContainer(nn.Module):
    """G-LSG bridge (reference ``pred_attribute.py:239-289``):

    * LSG: the top-k concept ids -> ``semantic_labels`` (from each of the
      given ``semantic_logits``' merged probabilities, concatenated, when
      the caller passes them), embedded by ``attr_embs`` ->
      ``semantic_embs``;
    * GSG: ``semantic2hidden`` of the (detached unless
      ``global_semantic_guidance_not_detach``) concept distribution ->
      ``semantic_hidden_states``; biased in ``pp_emb`` mode.
    """

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.topk = opt["use_attr_topk"]
        self.detach = not opt.get("global_semantic_guidance_not_detach",
                                  False)
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
                semantic_logits=None, **kwargs) -> Dict[str, Any]:
        if semantic_logits is None:
            _, semantic_labels = top_k(preds_attr, self.topk)
        else:
            if not isinstance(semantic_logits, (list, tuple)):
                raise TypeError("semantic_logits must be a list")
            semantic_labels = torch.cat(
                [top_k(prepare_merged_probs(l)[0], self.topk)[1]
                 for l in semantic_logits], dim=-1)
        semantic_embs = (None if self.attr_embs is None
                         else self.attr_embs(semantic_labels))
        semantic_hidden_states = None
        if self.semantic2hidden is not None:
            src = preds_attr.detach() if self.detach else preds_attr
            semantic_hidden_states = self.semantic2hidden(src)
        return {"semantic_embs": semantic_embs,
                "semantic_labels": semantic_labels,
                "semantic_hidden_states": semantic_hidden_states}


class PredictorLength(nn.Module):
    """The length distribution of NAR decoding (reference
    ``pred_length.py:5-22``): the mean over the encoder positions through
    ``net1``, ReLU, dropout and ``net2`` to ``max_len`` classes, as
    log-probabilities ``preds_length`` [B, max_len]."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        dim = opt["dim_hidden"]
        self.net1 = dense(dim, dim, generator)
        self.dropout = Dropout(opt["hidden_dropout_prob"])
        self.net2 = dense(dim, opt["max_len"], generator)

    def forward(self, encoder_hidden_states, **kwargs) -> Dict[str, Any]:
        if isinstance(encoder_hidden_states, (list, tuple)):
            if len(encoder_hidden_states) != 1:
                raise ValueError("the length predictor takes one stream")
            encoder_hidden_states = encoder_hidden_states[0]
        x = torch.relu(self.net1(encoder_hidden_states.mean(dim=1)))
        out = self.net2(self.dropout(x))
        return {"preds_length": torch.log_softmax(out, dim=-1)}


class Predictor(nn.Module):
    """Chained container: each net's outputs feed the next
    (reference ``Predictor/base.py:6-15``); the length predictor comes
    last, as in the JAX package."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.net_names = []
        for crit in opt["crits"]:
            if crit in ("lang", "length"):
                continue
            if crit != "attribute":
                raise ValueError(f"no predictor for crit `{crit}`")
            self.add_module("Predictor_attribute",
                            PredictorAttribute(opt, generator))
            self.net_names.append("Predictor_attribute")
        for name in opt.get("predictors_to_be_added", []) or []:
            if name != "SemanticContainer":
                raise ValueError(f"unknown predictor `{name}`")
            self.add_module(name, SemanticContainer(opt, generator))
            self.net_names.append(name)
        if "length" in opt["crits"]:
            self.add_module("Predictor_length",
                            PredictorLength(opt, generator))
            self.net_names.append("Predictor_length")

    def forward(self, encoder_hidden_states, **kwargs) -> Dict[str, Any]:
        results: Dict[str, Any] = {}
        for name in self.net_names:
            results.update(getattr(self, name)(encoder_hidden_states,
                                               **{**kwargs, **results}))
        return results

    def project_attribute(self, feats, flag: str):
        """The concept projection of ``flag`` (the first net's heads)."""
        return getattr(self, self.net_names[0]).project_with_flag(feats, flag)


def has_predictor(opt: dict) -> bool:
    crits = [c for c in opt["crits"] if c != "lang"]
    return bool(crits) or bool(opt.get("predictors_to_be_added"))
