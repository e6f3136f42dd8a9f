"""Loss / criterion system.

Port of ``care_tpu/training/losses.py`` (reference ``misc/Crit/``):

* the language NLL with label smoothing on log-softmax, the stripping of
  the G-LSG concept-prefix positions, and the word-accuracy and perplexity
  recorders, dense (``_lang_step``) or from the fused statistics of
  ``ops/fused_xent.py`` (``_lang_step_fused``);
* the noisy-OR MIL concept loss, BCE on the merged concept probabilities
  normalised by the number of positives (clamped to [0.01, 0.99]), the
  sparse-sampling L1 regulariser, and the F1@{5..50} and mAP recorders,
  for the encoder-side flag ``V`` and the decoder-side flags (``I``, ``S``,
  ... : a decoder output projected by the flag's head through
  ``project_fn``, merged over the non-PAD positions);
* the auxiliary ``attn`` (concept-attention mass hinge) and ``gate``
  (gate BCE against the non-stop-word mask) losses;
* NACF's multi-pass language loss (``visual_word_generation``: the
  ``nv_weights``, perplexity over the caption passes, the MASK-aware
  ``word_acc0``) and the ``length`` KL of NAR decoding;
* the ``Criterion`` aggregator with named scales.

Every value is a tensor on the model's device; the trainer fetches them
once per epoch. Pointer ``probs`` are not ported yet and raise
``NotImplementedError``.
"""

from typing import Any, Dict, List, Optional, Tuple

import torch

from care_tpu_torch import constants
from care_tpu_torch.models.common import unsupported
from care_tpu_torch.ops.fused_xent import vocab_xent_stats
from care_tpu_torch.models.predictors import prepare_merged_probs
from care_tpu_torch.ops.topk import top_k

# the decoder output each decoder-side concept flag projects
ATTR_FLAG_TO_KEY = {
    "P": "input_embs_exclude_bos",
    "I": "input_embs",
    "C": "context",
    "H": "hidden_states",
    "T": "text_context",
    "S": "sentence_embs",
    "A": "attr_embs",
}


def _as_list(x):
    return x if isinstance(x, (list, tuple)) else [x]


# ---------------------------------------------------------------------------
# language generation
# ---------------------------------------------------------------------------

def _strip_positions(opt, x, labels):
    """Drop the positions of ``x`` [B, L', ...] that carry no label: the
    concept prefix, the ``pp`` slot, or the last position."""
    use_attr = opt.get("use_attr", False)
    t = opt.get("use_attr_type") or ""
    if use_attr and "prefix" in t:
        assert x.shape[1] == labels.shape[1] + opt["use_attr_topk"]
        return x[:, opt["use_attr_topk"]:]
    if use_attr and "pp" in t:
        assert x.shape[1] == labels.shape[1] + 1
        return x[:, 1:]
    if x.shape[1] == labels.shape[1] + 1:
        return x[:, :-1]
    assert x.shape[1] == labels.shape[1], (x.shape, labels.shape)
    return x


def _lang_reduce(opt, nll, smooth, preds, labels):
    """(sum-loss, recorders) from the per-position NLL, the smoothing term
    and the argmax."""
    label_smoothing = opt.get("label_smoothing", 0.0)
    loss = (1.0 - label_smoothing) * nll + label_smoothing * smooth
    keep = labels != constants.PAD
    mask = keep.float()
    correct = (preds == labels) & keep
    metrics = {
        "word_acc_num": correct.float().sum(),
        "word_acc_den": mask.sum(),
        "xent_sum": (nll * mask).sum(),
        "xent_count": mask.sum(),
    }
    return (loss * mask).sum(), metrics


def _lang_step(opt, logits, labels):
    """One (logits, labels) pair -> (sum-loss, metrics)."""
    logits = _strip_positions(opt, logits, labels)
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, 2, labels[:, :, None])[:, :, 0]
    smooth = -logprobs.mean(dim=-1)
    return _lang_reduce(opt, nll, smooth, logprobs.argmax(dim=-1), labels)


def _lang_step_fused(opt, hidden, weight, labels):
    """Fused-xent variant of ``_lang_step``: the criterion's four
    statistics stream from (hidden, head weight [V, H]), so the [B, L, V]
    logits never exist; the same position slicing, loss algebra and
    recorders."""
    hidden = _strip_positions(opt, hidden, labels)
    V = weight.shape[0]
    lse, lab, tot, amax = vocab_xent_stats(
        hidden, weight, None, labels, opt.get("fused_xent_chunk", 1024))
    # log_softmax identities: nll = lse - label_logit;
    # -mean(logprobs) = lse - sum(logits)/V; argmax(logits)==argmax(logp)
    return _lang_reduce(opt, lse - lab, lse - tot / V, amax, labels)


def lang_loss(opt, results) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The language loss over every (logits, labels) pass. Under NACF's
    ``visual_word_generation`` the passes weigh by ``nv_weights``, the
    perplexity counts the caption passes only, and ``word_acc0`` (the
    visual-word pass) leaves the MASK targets out (reference
    ``crit_lang.py:75-78``)."""
    if results.get("probs") is not None:
        raise unsupported("probs (pointer copy probabilities)")
    labels = _as_list(results["labels"])

    if results.get("logits") is None and "cls_head_kernel" in results:
        # fused-xent path (the trainer hands over the head's weight; one
        # hidden stream, plain head: eligibility is decided there)
        assert len(labels) == 1
        hidden = results["hidden_states"]
        s, m = _lang_step_fused(opt, hidden, results["cls_head_kernel"],
                                labels[0])
        return s / hidden.shape[0], {
            "word_acc_num0": m["word_acc_num"],
            "word_acc_den0": m["word_acc_den"],
            "xent_sum": m["xent_sum"],
            "xent_count": m["xent_count"],
        }

    logits = _as_list(results["logits"])
    if len(labels) != len(logits):
        labels = labels * len(logits)
    visual_words = opt.get("visual_word_generation", False)
    weights = (opt.get("nv_weights", [0.8, 1.0]) if visual_words
               else [1.0] * len(logits))
    denom = logits[0].shape[0]
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    for i, (w, lg, lb) in enumerate(zip(weights, logits, labels)):
        s, m = _lang_step(opt, lg, lb)
        total = total + w * s / denom
        metrics[f"word_acc_num{i}"] = m["word_acc_num"]
        metrics[f"word_acc_den{i}"] = m["word_acc_den"]
        if i == 0 and visual_words:
            # the visual-word pass: no perplexity, and an accuracy that
            # leaves the MASK targets out (its prediction is not aligned
            # by _strip_positions, as in the JAX package)
            preds = torch.log_softmax(
                (lg if lg.shape[1] == lb.shape[1] else lg[:, :-1]).float(),
                dim=-1).argmax(dim=-1)
            keep = (lb != constants.PAD) & (lb != constants.MASK)
            metrics["word_acc_num0"] = ((preds == lb) & keep).float().sum()
            metrics["word_acc_den0"] = keep.float().sum()
            continue
        # perplexity accumulates across the caption-generation passes
        metrics["xent_sum"] = metrics.get("xent_sum", 0.0) + m["xent_sum"]
        metrics["xent_count"] = (metrics.get("xent_count", 0.0)
                                 + m["xent_count"])
    return total, metrics


# ---------------------------------------------------------------------------
# noisy-OR concept loss
# ---------------------------------------------------------------------------

def _noisy_or_mil(opt, preds_attr, avg_prob_attr, labels_attr,
                  with_metrics: bool = False):
    preds_attr = torch.clamp(preds_attr, 0.01, 0.99)
    labels_attr = labels_attr[:, :preds_attr.shape[1]].float()

    n_positive = labels_attr.sum(dim=1)
    n_attributes = preds_attr.shape[1]

    bce = -(labels_attr * torch.log(preds_attr)
            + (1.0 - labels_attr) * torch.log(1.0 - preds_attr))
    loss = bce.sum(dim=1) / torch.clamp_min(n_positive, 1.0)

    if (opt.get("attribute_prediction_sparse_sampling", False)
            and avg_prob_attr is not None):
        threshold = n_positive / n_attributes
        loss = loss + torch.abs(torch.maximum(avg_prob_attr, threshold)
                                - threshold)

    metrics: Dict[str, torch.Tensor] = {}
    if with_metrics:
        # F1@k ladder (reference pred_attribute.py evaluation ks), clamped
        # to the attribute-vocabulary size for small (synthetic) corpora
        topk_list = [k for k in (5, 10, 20, 30, 40, 50)
                     if k <= n_attributes] or [n_attributes]
        _, candidates = top_k(preds_attr, max(topk_list))
        hits = torch.gather(labels_attr, 1, candidates)
        for topk in topk_list:
            n_hit = hits[:, :topk].sum(dim=1)
            n_hit = torch.where(n_hit == 0, 1e-3, n_hit)
            precision = n_hit / topk
            recall = n_hit / torch.clamp_min(n_positive, 1e-6)
            f1 = 2 * precision * recall / (precision + recall)
            metrics[f"f1_{topk}_sum"] = f1.sum()
            metrics[f"f1_{topk}_count"] = f1.new_tensor(
                float(preds_attr.shape[0]))
        # mAP: mean over samples of AP over positive labels; stable sorts,
        # so equal probabilities rank lowest index first
        order = torch.argsort(-preds_attr, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        pos_mask = labels_attr > 0
        big = torch.where(pos_mask, rank, n_attributes + 1)
        sorted_hit_rank = torch.sort(big, dim=1).values    # positives first
        ids = torch.arange(n_attributes, device=preds_attr.device)[None, :]
        valid = ids < n_positive[:, None]
        prec = (ids + 1.0) / (sorted_hit_rank + 1.0)
        ap = (torch.where(valid, prec, 0.0).sum(dim=1)
              / torch.clamp_min(n_positive, 1.0))
        has_pos = n_positive > 0
        metrics["ap_sum"] = torch.where(has_pos, ap, 0.0).sum()
        metrics["ap_count"] = has_pos.float().sum()
    return loss.sum(), metrics


def attribute_losses(opt, results, project_fn=None,
                     with_metrics: bool = False):
    """The concept losses for ``attribute_prediction_flags``: ``V`` on the
    detector's ``preds_attr``; every other flag on the decoder output
    ``ATTR_FLAG_TO_KEY`` names, projected by ``project_fn(feats, flag)``
    and merged over its non-PAD positions."""
    flags = opt["attribute_prediction_flags"]
    scales = opt.get("attribute_prediction_scales", [1.0])
    if not isinstance(scales, list):
        scales = [scales]
    if len(scales) == 1:
        scales = scales * len(flags)
    assert len(scales) == len(flags)

    labels_attr = results["labels_attr"]
    denom = labels_attr.shape[0]
    out: Dict[str, torch.Tensor] = {}
    metrics: Dict[str, torch.Tensor] = {}
    total = 0.0
    for flag, scale in zip(flags, scales):
        if flag == "V":
            s, m = _noisy_or_mil(opt, results["preds_attr"],
                                 results["avg_prob_attr"], labels_attr,
                                 with_metrics=with_metrics)
        else:
            feats = results[ATTR_FLAG_TO_KEY[flag]]
            if isinstance(feats, list):
                feats = feats[-1]
            scores = project_fn(feats, flag)
            labels = _as_list(results["labels"])[-1]
            if scores.shape[1] == labels.shape[1] + 1:
                # embeddings may carry the BOS / prefix position
                scores = scores[:, :labels.shape[1], :]
            preds, avg_prob = prepare_merged_probs(
                scores, labels == constants.PAD)
            s, m = _noisy_or_mil(opt, preds, avg_prob, labels_attr,
                                 with_metrics=with_metrics)
        loss = s / denom
        out[f"{flag}-Attr"] = loss * scale
        total = total + loss * scale
        for k, v in m.items():
            metrics[f"{flag}_{k}"] = v
    return total, out, metrics


# ---------------------------------------------------------------------------
# length KL
# ---------------------------------------------------------------------------

def length_loss(opt, results):
    """KL(target || preds), summed over the lengths and averaged over the
    batch (reference ``crit_length.py``; ``preds_length`` is already a
    log-softmax); lengths the target gives no mass add nothing."""
    preds = results["preds_length"]
    target = results["length_target"]
    has_mass = target > 0
    safe_log_t = torch.where(has_mass,
                             torch.log(torch.clamp_min(target, 1e-20)), 0.0)
    kl = torch.where(has_mass, target * (safe_log_t - preds), 0.0)
    return kl.sum() / preds.shape[0], {}


# ---------------------------------------------------------------------------
# auxiliary attention losses (the reference's ``crit_attn.py``; no shipped
# configuration reaches them, the JAX package keeps them under the crits
# ``attn`` and ``gate``)
# ---------------------------------------------------------------------------

def attn_sparse_loss(opt, results):
    """L1 hinge pushing each word's concept-attention mass toward a
    threshold (reference ``crit_attn.py:7-38``)."""
    probs = results["attr_attention_probs"]
    if isinstance(probs, (list, tuple)):
        probs = probs[-1]
    labels = _as_list(results["labels"])[-1]
    threshold = float(opt.get("use_attr_attn_loss_threshold", 1))
    mass = probs.sum(-1).mean(1)                 # (bsz, seq_len)
    pad = labels == constants.PAD
    mass = torch.where(pad, threshold, mass)
    target = torch.full(labels.shape, threshold, device=mass.device)
    if opt.get("use_attr_attn_loss_mask", False):
        target = torch.where(results["attribute_mask"] == 0, 0.0, target)
    mass = torch.where(mass < target, threshold, mass)
    loss = torch.abs(mass - target)
    keep = (~pad).float()
    loss = (loss * keep).sum(dim=1) / torch.clamp_min(keep.sum(dim=1), 1.0)
    return loss.sum() / labels.shape[0], {}


def gate_loss(opt, results):
    """BCE of the gate probabilities against the non-stop-word mask
    (reference ``crit_attn.py:41-66``)."""
    labels = _as_list(results["labels"])[-1]
    target = results["non_stop_words_mask"].reshape(-1).float()
    valid = (labels != constants.PAD).reshape(-1).float()
    loss = 0.0
    for probs in _as_list(results["gate_probs"]):
        p = probs.mean(2).reshape(-1)
        loss = loss - (target * torch.log(p + 1e-12)
                       + (1 - target) * torch.log(1 - p + 1e-12))
    loss = (loss * valid).sum()
    if opt.get("attentive_loss_wise", False):
        return loss / torch.clamp_min(valid.sum(), 1.0), {}
    return loss / labels.shape[0], {}


# ---------------------------------------------------------------------------
# criterion aggregator
# ---------------------------------------------------------------------------

PORTED_CRITS = ("lang", "attribute", "length", "attn", "gate")


class Criterion:
    """Weighted multi-task loss with named components
    (reference ``misc/Crit/base.py:50-113``)."""

    def __init__(self, opt: dict, skip_crit_list: List[str] = (),
                 override_opt: Optional[dict] = None,
                 with_metrics: bool = False):
        o = dict(opt)
        if override_opt:
            o.update(override_opt)
        self.opt = o
        self.crits = [c for c in o["crits"] if c not in skip_crit_list]
        for crit in self.crits:
            if crit not in PORTED_CRITS:
                raise ValueError(f"unknown crit `{crit}`")
        self.with_metrics = with_metrics
        self.scales = {c: 1.0 for c in self.crits}
        if "lang" in self.scales:
            self.scales["lang"] = o.get("language_generation_scale", 1.0)
        if "length" in self.scales:
            self.scales["length"] = o.get("length_prediction_scale", 1.0)

    def set_scales(self, new_scales: Dict[str, float]):
        self.scales.update(new_scales)

    def __call__(self, results: Dict[str, Any], project_fn=None):
        """Returns (total_loss, loss_dict, metrics_dict), all tensors;
        ``project_fn(feats, flag)`` is the model's concept projection, for
        the decoder-side concept flags."""
        total = 0.0
        losses: Dict[str, torch.Tensor] = {}
        metrics: Dict[str, torch.Tensor] = {}
        for crit in self.crits:
            if crit == "lang":
                l, m = lang_loss(self.opt, results)
                losses["Lang Loss"] = l
                metrics.update(m)
                total = total + l * self.scales["lang"]
            elif crit == "attribute":
                l, per, m = attribute_losses(self.opt, results, project_fn,
                                             with_metrics=self.with_metrics)
                losses.update(per)
                metrics.update(m)
                total = total + l * self.scales.get("attribute", 1.0)
            elif crit == "length":
                l, _ = length_loss(self.opt, results)
                losses["Length Loss"] = l
                total = total + l * self.scales["length"]
            elif crit == "attn":
                l, _ = attn_sparse_loss(self.opt, results)
                losses["Attn Loss"] = l
                total = total + l * self.scales.get("attn", 1.0)
            else:
                l, _ = gate_loss(self.opt, results)
                losses["Gate Loss"] = l
                total = total + l * self.scales.get("gate", 1.0)
        return total, losses, metrics
