"""Plain PyTorch reference of PointerGen CARE: the CARE captioner of
``reference/care.py`` (encoder, concept detector, concept-guided decoder,
vocab head) with the pointer-generator copy head over the retrieved
captions, in float32, as it serves: no dropout.

Written from the public implementation (https://github.com/yangbang18/CARE:
``models/Pointer.py:18-74``, a pointer-generator after See et al., 2017;
``models/Encoder.py:341-376`` for the retrieved captions' embeddings) and
the paper's versatility table (``scripts/exp_versatility_of_CARE.sh:74``).
It imports nothing of the program; parameters are looked up by the
state-dict names of the program's ``Captioner``.

The retrieved captions (the ``t`` stream, token ids [B, R, S]) take the
decoder's word and position embeddings and its embedding LayerNorm
(``has_retrieval_embs`` and ``has_retrieval_rnn`` off). At each decoder
position and for each retrieval r, a one-head attention of the decoder's
hidden state over the caption's tokens (PAD hidden) gives the attention
``a_r`` and the context ``c_r``; the gate is ``p_r = copy_scale *
sigmoid(Wq h + Wc c_r)``; the distribution is ``(1 - p_r) *
softmax(logits)`` plus ``p_r * a_r`` added at the caption's ids; the mean
over the R retrievals gives ``probs``, and a served token is scored by
``log(probs + 1e-9)``, as the decode step scores it.

Departures:

* a served caption is scored as a sequence of generated tokens (causal mask
  only), where the public decoder would also hide a generated PAD token as
  a key (as in ``reference/care.py``);
* the retrieved captions are taken once a video, not enlarged to the beam's
  rows: one video's captions serve all its rows, and the reference scores
  one caption at a time;
* the copy mass is added by a product with the one-hot rows of the ids
  (``matmul``), not by a scatter, so that the sum over repeated ids is one
  fixed sum and the control's precision reaches it too.

Every product goes through ``care.matmul`` / ``care.linear``, so the
control computes the same reference in a lower precision
(``precision("tf32")``).
"""

import math

import torch
import torch.nn.functional as F

from portbench.reference import care
from portbench.reference.care import (BOS, NEG, PAD, linear, matmul,
                                      precision)  # noqa: F401

HEAD = "pointer"


def float_model(m: dict) -> dict:
    """The ``model`` block of the float streams alone: the ``t`` stream is
    token ids, which no encoder projects."""
    return dict(m, modality=m["modality"].replace("t", ""))


def retrieval_shape(m: dict) -> tuple:
    """(R, S): the retrieved captions a video and their length in ids."""
    return m["retrieval_topk"], m["max_len"]


def param_shapes(m: dict) -> dict:
    """CARE's parameters over the float streams, and the copy head's."""
    H = m["dim_hidden"]
    s = care.param_shapes(float_model(m))
    for p in ("query", "key", "value"):
        s[f"{HEAD}.attention.{p}.weight"] = (H, H)
        s[f"{HEAD}.attention.{p}.bias"] = (H,)
    for p in ("Wq", "Wc"):
        s[f"{HEAD}.{p}.weight"] = (1, H)
        s[f"{HEAD}.{p}.bias"] = (1,)
    return s


def concept_scores(P, m, feats):
    """``care.concept_scores`` over the float streams of ``feats``
    (modality char -> tensor; a ``t`` entry is left out)."""
    fm = float_model(m)
    return care.concept_scores(P, fm, {c: feats[c] for c in fm["modality"]})


def retrieved_embs(P, m, ids):
    """The retrieved captions' embeddings [B, R, S, H] from their ids
    [B, R, S]: the decoder's word and position embeddings, its embedding
    LayerNorm."""
    e = "decoder.embedding"
    S = ids.shape[-1]
    x = (P[e + ".word_embeddings"][ids]
         + P[e + ".position_embeddings.embedding"][:S])
    return care.layer_norm(x, P, e + ".LayerNorm", m["layer_norm_eps"])


def copy_probs(P, m, hidden, logits, embs, ids):
    """The copy head's distribution [B, L, V] for the decoder's hidden
    states ``hidden`` [B, L, H] and logits [B, L, V], over the retrieved
    captions ``embs`` [B, R, S, H] with ids ``ids`` [B, R, S]."""
    a = f"{HEAD}.attention"
    V = logits.shape[-1]
    scale = 1.0 / math.sqrt(hidden.shape[-1])
    q = linear(hidden, P[a + ".query.weight"], P[a + ".query.bias"])
    gen = torch.softmax(logits, dim=-1)
    total = torch.zeros_like(gen)
    R = ids.shape[1]
    for r in range(R):
        k = linear(embs[:, r], P[a + ".key.weight"], P[a + ".key.bias"])
        v = linear(embs[:, r], P[a + ".value.weight"], P[a + ".value.bias"])
        pad = torch.where(ids[:, r] == PAD, NEG, 0.0)[:, None, :]
        attn = torch.softmax(matmul(q, k.transpose(-1, -2)) * scale + pad,
                             dim=-1)                             # [B, L, S]
        ctx = matmul(attn, v)                                    # [B, L, H]
        gate = (linear(hidden, P[HEAD + ".Wq.weight"], P[HEAD + ".Wq.bias"])
                + linear(ctx, P[HEAD + ".Wc.weight"], P[HEAD + ".Wc.bias"]))
        p = m["copy_scale"] * torch.sigmoid(gate)                # [B, L, 1]
        onehot = F.one_hot(ids[:, r], V).to(attn.dtype)          # [B, S, V]
        total = total + (1 - p) * gen + matmul(p * attn, onehot)
    return total / R


def log_probs(P, m, hidden, embs, ids):
    """``log(probs + 1e-9)`` [B, L, V], the decode step's scores."""
    logits = linear(hidden, P["cls_head.tgt_word_prj.weight"]).float()
    return torch.log(copy_probs(P, m, hidden, logits, embs, ids) + 1e-9)


def token_log_probs(P, m, states, preds, labels, ret_ids, tokens):
    """One caption's scores [len(tokens), V] at each of its positions: the
    decoder's full forward over BOS and the tokens before each, the copy
    head over the video's retrieved captions ``ret_ids`` [1, R, S]."""
    enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    ids = torch.tensor([[BOS] + list(tokens[:-1])], device=enc.device)
    hidden = care.decode(P, m, ids, enc, gsg)
    return log_probs(P, m, hidden, retrieved_embs(P, m, ret_ids),
                     ret_ids)[0]
