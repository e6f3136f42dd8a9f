"""Transformer sublayers and the decoder layer.

Port of ``care_tpu/models/layers.py`` (reference
``models/components/SubLayers.py`` and ``Layers.py``) for the branches the
CARE flagship runs: post-LN multi-head attention with the learned hybrid
bias over the cross-attention keys, the position-wise FFN, and a decoder
layer (self-attention -> cross-attention -> FFN) with a full forward and a
KV-cached one-token step. Masks are additive f32 biases (0 / -1e9).
"""

import torch
from torch import nn

from care_tpu_torch.models.common import (Dropout, dense, get_activation,
                                          unsupported)
from care_tpu_torch.ops.attention import dot_product_attention


def split_heads(x, num_heads: int):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class MultiHeadAttention(nn.Module):
    """Attention (with dropout on its probabilities) + output dense +
    dropout + residual + LN.

    ``hybrid_length`` > 0 adds a learned per-head bias ``hybrid_bias``
    [H, Lk] over the key axis (the "HA" of CARE's LSG, reference
    ``Attention.py:47-51,109-111``).
    """

    def __init__(self, dim_hidden: int, num_attention_heads: int,
                 hidden_dropout_prob: float, layer_norm_eps: float,
                 generator: torch.Generator, exclude_bias: bool = False,
                 hybrid_length: int = 0,
                 attention_probs_dropout_prob: float = 0.0):
        super().__init__()
        self.num_attention_heads = num_attention_heads
        use_bias = not exclude_bias
        self.query = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.key = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.value = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.dense = dense(dim_hidden, dim_hidden, generator)
        if hybrid_length:
            self.hybrid_bias = nn.Parameter(
                torch.zeros(num_attention_heads, hybrid_length))
        else:
            self.hybrid_bias = None
        self.LayerNorm = nn.LayerNorm(dim_hidden, eps=layer_norm_eps)
        self.attn_dropout = Dropout(attention_probs_dropout_prob)
        self.out_dropout = Dropout(hidden_dropout_prob)

    def project_q(self, x):
        return split_heads(self.query(x), self.num_attention_heads)

    def project_kv(self, x):
        """Keys and values in head form [B, H, L, Dh]."""
        h = self.num_attention_heads
        return split_heads(self.key(x), h), split_heads(self.value(x), h)

    def project_qkv(self, x):
        """Self-attention q/k/v in one [3D, D] product for the decode step;
        each output element is the same dot product as in the separate
        projections. Returns (q, (k, v)) in head form."""
        w = torch.cat([self.query.weight, self.key.weight, self.value.weight])
        b = (None if self.query.bias is None else
             torch.cat([self.query.bias, self.key.bias, self.value.bias]))
        q, k, v = nn.functional.linear(x, w, b).chunk(3, dim=-1)
        h = self.num_attention_heads
        return split_heads(q, h), (split_heads(k, h), split_heads(v, h))

    def make_bias(self, attention_mask):
        """The pad/causal mask (already additive, [B, 1, Lq, Lk]) plus the
        hybrid bias, in the reference's order."""
        bias = attention_mask
        if self.hybrid_bias is not None:
            hb = self.hybrid_bias[None, :, None, :]
            bias = hb if bias is None else bias + hb
        return bias

    def attend(self, q, k, v, bias, input_tensor):
        """Attention over pre-projected q/k/v (head form).

        Beam-grouped cross attention: when the query batch is a multiple of
        the key batch (q [B*beam, H, 1, Dh] against k/v [B, H, Lk, Dh], rows
        instance-major), the beam folds into the query-length axis, so the
        keys of one instance are read once per step rather than once per
        beam row. The bias must then broadcast over the batch.
        """
        bq, nh, lq, dh = q.shape
        bk = k.shape[0]
        grouped = bk != bq
        if grouped:
            if lq != 1 or bq % bk:
                raise ValueError(f"cannot group q {tuple(q.shape)} over "
                                 f"k {tuple(k.shape)}")
            q = q.reshape(bk, bq // bk, nh, dh).transpose(1, 2)
        context, probs = dot_product_attention(q, k, v, bias=bias,
                                               dropout=self.attn_dropout)
        if grouped:
            context = context.transpose(1, 2).reshape(bq, nh, 1, dh)
            probs = probs.transpose(1, 2).reshape(bq, nh, 1, probs.shape[-1])
        context = self.out_dropout(self.dense(merge_heads(context)))
        return self.LayerNorm(context + input_tensor), probs, context

    def forward(self, hidden_states, encoder_hidden_states=None,
                attention_mask=None):
        kv_in = (hidden_states if encoder_hidden_states is None
                 else encoder_hidden_states)
        k, v = self.project_kv(kv_in)
        return self.attend(self.project_q(hidden_states), k, v,
                           self.make_bias(attention_mask), hidden_states)


class PositionwiseFeedForward(nn.Module):
    """2-layer FFN + dropout + residual + post-LN (reference
    ``SubLayers.py:108-152``)."""

    def __init__(self, dim_hidden: int, dim_intermediate: int,
                 hidden_act: str, hidden_dropout_prob: float,
                 layer_norm_eps: float, generator: torch.Generator):
        super().__init__()
        self.dense1 = dense(dim_hidden, dim_intermediate, generator)
        self.dense2 = dense(dim_intermediate, dim_hidden, generator)
        self.act = get_activation(hidden_act)
        self.dropout = Dropout(hidden_dropout_prob)
        self.LayerNorm = nn.LayerNorm(dim_hidden, eps=layer_norm_eps)

    def forward(self, hidden_states):
        out = self.dropout(self.dense2(self.act(self.dense1(hidden_states))))
        return self.LayerNorm(out + hidden_states)


def compute_hybrid_length(opt: dict) -> int:
    """Length of the cross-attention key axis for the hybrid bias
    (reference ``Layers.py:85-90``)."""
    modality = opt.get("modality_for_decoder") or opt["modality"]
    hybrid_length = (opt["n_frames"] * len(modality)
                     + opt.get("use_attr_topk", 30))
    if opt.get("feats") == "SwinBERTDense" and "m" in modality:
        hybrid_length = hybrid_length - opt["n_frames"] + 1568
    if "r" in modality:
        hybrid_length += opt["retrieval_topk"] - opt["n_frames"]
    return hybrid_length


def _check_layer_opt(opt: dict, hybrid_length: int) -> None:
    for key in ("RPE", "transformer_pre_ln", "compositional_intra",
                "compositional_inter", "compositional_ffn"):
        if opt.get(key):
            raise unsupported(key, opt[key])
    if opt.get("fusion", "temporal_concat") != "temporal_concat":
        raise unsupported("fusion", opt["fusion"])
    t = opt.get("use_attr_type") or ""
    if opt.get("use_attr") and ("att" in t or "prefix" in t or "pp" in t):
        raise unsupported("use_attr_type", t)
    upa = opt.get("use_pallas_attention", "auto")
    if upa is True or (upa == "auto" and hybrid_length >= 512):
        # the JAX package switches to its flash kernel here
        raise unsupported("use_pallas_attention at "
                          f"{hybrid_length} cross-attention keys")


class DecoderLayer(nn.Module):
    """Self-attention -> cross-attention (with the hybrid bias) -> FFN,
    with a full forward and a KV-cached single-token step."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        hybrid_length = compute_hybrid_length(opt)
        _check_layer_opt(opt, hybrid_length)
        common = dict(dim_hidden=opt["dim_hidden"],
                      num_attention_heads=opt["num_attention_heads"],
                      hidden_dropout_prob=opt["hidden_dropout_prob"],
                      attention_probs_dropout_prob=opt[
                          "attention_probs_dropout_prob"],
                      layer_norm_eps=opt["layer_norm_eps"],
                      exclude_bias=opt.get("mha_exclude_bias", False),
                      generator=generator)
        self.intra_attention = MultiHeadAttention(**common)
        self.inter_attention = MultiHeadAttention(
            **common,
            hybrid_length=(hybrid_length
                           if opt.get("add_hybrid_attention_bias") else 0))
        self.ffn = PositionwiseFeedForward(
            opt["dim_hidden"], opt["intermediate_size"], opt["hidden_act"],
            opt["hidden_dropout_prob"], opt["layer_norm_eps"], generator)

    def forward(self, hidden_states, encoder_hidden_states,
                attention_mask=None, encoder_attention_mask=None):
        """Returns (hidden [B, L, D], (intra_probs, inter_probs))."""
        hidden_states, intra_probs, _ = self.intra_attention(
            hidden_states, attention_mask=attention_mask)
        hidden_states, inter_probs, _ = self.inter_attention(
            hidden_states, encoder_hidden_states,
            attention_mask=encoder_attention_mask)
        return self.ffn(hidden_states), (intra_probs, inter_probs)

    # ----- KV-cached single-step decode ------------------------------------
    def init_step(self, encoder_hidden_states):
        """Cross-attention K/V, computed once per decode."""
        return self.inter_attention.project_kv(encoder_hidden_states)

    def self_qkv(self, token_embs):
        return self.intra_attention.project_qkv(token_embs)

    def step(self, x, self_kv, inter_kv, self_bias, q):
        """One decode step. x: [B, 1, D]; self_kv: (k, v) [B, H, Lmax, Dh]
        already holding this step's K/V; ``self_bias`` [1, 1, 1, Lmax]
        masks the future; ``q`` the step's self-attention query from
        ``self_qkv``. Returns the new hidden state [B, 1, D]."""
        h, _, _ = self.intra_attention.attend(
            q, self_kv[0], self_kv[1],
            self.intra_attention.make_bias(self_bias), x)
        qc = self.inter_attention.project_q(h)
        h, _, _ = self.inter_attention.attend(
            qc, inter_kv[0], inter_kv[1],
            self.inter_attention.make_bias(None), h)
        return self.ffn(h)
