"""Plain PyTorch reference of the CARE captioner (multi-stream encoder,
concept detector, concept-guided Transformer decoder, vocab head), in
float32, as it serves: no dropout.

Written from the paper's model (Yang et al., "Concept-Aware Video
Captioning", TIP 2023) and its public implementation
(https://github.com/yangbang18/CARE: ``models/Encoder.py``,
``models/Predictor/pred_attribute.py``, ``models/Decoder/Transformer.py``,
``models/Wrapper.py``): no kernel, no cache, no batching
tricks. It imports nothing of the program. Parameters are looked up by the
names of ``param_shapes``, which are the state-dict names of the program's
``Captioner``; the harness loads the same tensors into both.

Departure: a served caption is scored as a sequence of generated tokens
(causal mask only), where the public decoder would also hide a generated
PAD token as a key.

``matmul`` is the one place every product goes through, so that the
control can compute the same reference in a lower precision
(``precision("tf32")``).
"""

import contextlib
import math

import torch
import torch.nn.functional as F

PAD, BOS, EOS = 0, 2, 3
NEG = -1e9

_PRECISION = ["f32"]


@contextlib.contextmanager
def precision(name: str):
    """Compute the reference's products in ``name``: ``f32`` (TF32 off) or
    ``tf32`` (the tensor cores' TF32 on the card; on the CPU the operands
    rounded to TF32's 10-bit mantissa, which is what the card does)."""
    old = _PRECISION[0]
    cuda = torch.backends.cuda.matmul
    old_tf32 = cuda.allow_tf32
    _PRECISION[0] = name
    cuda.allow_tf32 = name == "tf32"
    try:
        yield
    finally:
        _PRECISION[0] = old
        cuda.allow_tf32 = old_tf32


def _round_tf32(x):
    """``x`` rounded to TF32; the gradient passes as if unrounded."""
    bits = x.detach().contiguous().view(torch.int32)
    rounded = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return x + (rounded - x).detach()


def _operands(a, b):
    if _PRECISION[0] == "tf32" and not a.is_cuda:
        return _round_tf32(a), _round_tf32(b)
    return a, b


def matmul(a, b):
    a, b = _operands(a, b)
    return torch.matmul(a, b)


def linear(x, w, b=None):
    x, w = _operands(x, w)
    return F.linear(x, w, b)


def layer_norm(x, P, name, eps):
    return F.layer_norm(x, (x.shape[-1],), P[name + ".weight"],
                        P[name + ".bias"], eps)


def param_shapes(m: dict) -> dict:
    """Parameter name -> shape for the configuration's ``model`` block."""
    H, V, K = m["dim_hidden"], m["vocab_size"], m["attribute_prediction_k"]
    F_ = m["intermediate_size"]
    s = {}
    for c in m["modality"]:
        pre = f"encoder.Encoder_{c.upper()}"
        s[pre + ".linear.weight"] = (H, m["dims"][c])
        s[pre + ".linear.bias"] = (H,)
        s[pre + ".ln.weight"] = (H,)
        s[pre + ".ln.bias"] = (H,)
    n_pred = len(m["modality_for_predictor"])
    pa = "predictor.Predictor_attribute.attribute_heads.prj"
    s[pa + ".weight"] = (K, H * n_pred)
    s[pa + ".bias"] = (K,)
    sc = "predictor.SemanticContainer"
    s[sc + ".attr_embs.word_embeddings"] = (K, H)
    s[sc + ".attr_embs.position_embeddings"] = (m["use_attr_topk"], H)
    s[sc + ".attr_embs.LayerNorm.weight"] = (H,)
    s[sc + ".attr_embs.LayerNorm.bias"] = (H,)
    s[sc + ".semantic2hidden.weight"] = (H, K)
    s["decoder.embedding.word_embeddings"] = (V, H)
    s["decoder.embedding.position_embeddings.embedding"] = (m["max_len"], H)
    s["decoder.embedding.LayerNorm.weight"] = (H,)
    s["decoder.embedding.LayerNorm.bias"] = (H,)
    for l in range(m["num_hidden_layers_decoder"]):
        pre = f"decoder.layer_{l}"
        for att in ("intra_attention", "inter_attention"):
            if att == "inter_attention":
                s[f"{pre}.{att}.hybrid_bias"] = (m["num_attention_heads"],
                                                 m["cross_attention_keys"])
            for p in ("query", "key", "value", "dense"):
                s[f"{pre}.{att}.{p}.weight"] = (H, H)
                s[f"{pre}.{att}.{p}.bias"] = (H,)
            s[f"{pre}.{att}.LayerNorm.weight"] = (H,)
            s[f"{pre}.{att}.LayerNorm.bias"] = (H,)
        s[f"{pre}.ffn.dense1.weight"] = (F_, H)
        s[f"{pre}.ffn.dense1.bias"] = (F_,)
        s[f"{pre}.ffn.dense2.weight"] = (H, F_)
        s[f"{pre}.ffn.dense2.bias"] = (H,)
        s[f"{pre}.ffn.LayerNorm.weight"] = (H,)
        s[f"{pre}.ffn.LayerNorm.bias"] = (H,)
    s["cls_head.tgt_word_prj.weight"] = (V, H)
    return s


def concept_scores(P, m, feats):
    """The encoder streams and the concept detector's noisy-OR
    probabilities. ``feats``: modality char -> [B, rows, dim]."""
    eps = m["layer_norm_eps"]
    states = {}
    for c in m["modality"]:
        pre = f"encoder.Encoder_{c.upper()}"
        h = linear(feats[c], P[pre + ".linear.weight"],
                   P[pre + ".linear.bias"])
        states[c] = layer_norm(h, P, pre + ".ln", eps)
    # channel-concatenated mean over each stream (mean pooling): one
    # instance, so the noisy-OR 1 - prod(1 - p) is over one term
    pooled = torch.cat([states[c].mean(dim=1)
                        for c in m["modality_for_predictor"]], -1)[:, None]
    pa = "predictor.Predictor_attribute.attribute_heads.prj"
    s = linear(pooled, P[pa + ".weight"], P[pa + ".bias"])
    p = torch.sigmoid(s.float())
    log_not = torch.log(torch.clamp(1.0 - p, 1e-12, 1.0))
    preds = 1.0 - torch.exp(log_not.sum(dim=1))
    return states, preds


def concept_order(preds, k):
    """The top-``k`` concepts by probability, the lower id first among equal
    values."""
    return torch.sort(-preds, dim=1, stable=True)[1][:, :k]


def decoder_inputs(P, m, states, preds, labels):
    """The concept-slot embeddings appended to the decoder's streams (LSG)
    and the concept vector added to every word (GSG)."""
    sc = "predictor.SemanticContainer"
    k = m["use_attr_topk"]
    slots = (P[sc + ".attr_embs.word_embeddings"][labels]
             + P[sc + ".attr_embs.position_embeddings"][None, :k])
    slots = layer_norm(slots, P, sc + ".attr_embs.LayerNorm",
                       m["layer_norm_eps"])
    gsg = linear(preds.detach(), P[sc + ".semantic2hidden.weight"])
    enc = torch.cat([states[c] for c in m["modality_for_decoder"]] + [slots],
                    dim=1)
    return enc, gsg


def _heads(x, n):
    b, l, d = x.shape
    return x.reshape(b, l, n, d // n).transpose(1, 2)


def _attention(P, m, pre, x, kv, bias):
    n = m["num_attention_heads"]
    q = _heads(linear(x, P[pre + ".query.weight"], P[pre + ".query.bias"]), n)
    k = _heads(linear(kv, P[pre + ".key.weight"], P[pre + ".key.bias"]), n)
    v = _heads(linear(kv, P[pre + ".value.weight"], P[pre + ".value.bias"]), n)
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = matmul(q, k.transpose(-1, -2)) * scale + bias
    probs = torch.softmax(scores, dim=-1)
    ctx = matmul(probs, v).transpose(1, 2).reshape(x.shape)
    out = linear(ctx, P[pre + ".dense.weight"], P[pre + ".dense.bias"])
    return layer_norm(out + x, P, pre + ".LayerNorm", m["layer_norm_eps"])


def decode(P, m, ids, enc, gsg):
    """The decoder's full forward over ``ids`` [B, L] (teacher forcing):
    the hidden states [B, L, H] before the vocab head, under the causal
    mask alone, as a served caption is scored."""
    eps = m["layer_norm_eps"]
    L = ids.shape[1]
    e = "decoder.embedding"
    x = (P[e + ".word_embeddings"][ids]
         + P[e + ".position_embeddings.embedding"][None, :L] + gsg[:, None])
    x = layer_norm(x, P, e + ".LayerNorm", eps)
    future = torch.ones(L, L, dtype=torch.bool, device=ids.device).triu(1)
    self_bias = torch.zeros(L, L, device=ids.device).masked_fill(future, NEG)
    self_bias = self_bias[None, None]
    for l in range(m["num_hidden_layers_decoder"]):
        pre = f"decoder.layer_{l}"
        x = _attention(P, m, pre + ".intra_attention", x, x, self_bias)
        hb = P[pre + ".inter_attention.hybrid_bias"][None, :, None, :]
        x = _attention(P, m, pre + ".inter_attention", x, enc, hb)
        f = pre + ".ffn"
        h = torch.relu(linear(x, P[f + ".dense1.weight"],
                              P[f + ".dense1.bias"]))
        y = linear(h, P[f + ".dense2.weight"], P[f + ".dense2.bias"])
        x = layer_norm(y + x, P, f + ".LayerNorm", eps)
    return x


def log_probs(P, hidden):
    return torch.log_softmax(
        linear(hidden, P["cls_head.tgt_word_prj.weight"]).float(), dim=-1)
