"""Transformer sublayers and the decoder layer.

Port of ``care_tpu/models/layers.py`` (reference
``models/components/SubLayers.py`` and ``Layers.py``): post- or pre-LN
multi-head attention with the learned hybrid bias over the cross-attention
keys and the relative-position bias, the position-wise FFN, and a decoder
layer (self-attention -> cross-attention -> FFN) with a full forward and a
KV-cached one-token step whose cross attention takes the flash kernel once
the key axis is long. Masks are additive f32 biases (0 / -1e9).
"""

import torch
from torch import nn

from care_tpu_torch.models.common import (Dropout, LayerNorm, dense,
                                          get_activation, unsupported)
from care_tpu_torch.models.embeddings import RelativePositionBias
from care_tpu_torch.ops.attention import dot_product_attention


def split_heads(x, num_heads: int):
    b, l, d = x.shape
    return x.reshape(b, l, num_heads, d // num_heads).transpose(1, 2)


def merge_heads(x):
    b, h, l, dh = x.shape
    return x.transpose(1, 2).reshape(b, l, h * dh)


class MultiHeadAttention(nn.Module):
    """Attention (with dropout on its probabilities) + output dense +
    dropout + residual + LN (after the residual, or with ``pre_ln`` on the
    sublayer's input).

    ``hybrid_length`` > 0 adds a learned per-head bias ``hybrid_bias``
    [H, Lk] over the key axis (the "HA" of CARE's LSG, reference
    ``Attention.py:47-51,109-111``). ``have_relative_position_bias`` adds a
    ``RelativePositionBias`` table ``rpe``; with ``attend_to_video`` its
    ``n_frames`` columns are tiled over the concatenated streams.
    ``use_flash`` sends a call that asks for no probabilities to the flash
    attention kernel.
    """

    def __init__(self, dim_hidden: int, num_attention_heads: int,
                 hidden_dropout_prob: float, layer_norm_eps: float,
                 generator: torch.Generator, exclude_bias: bool = False,
                 hybrid_length: int = 0,
                 attention_probs_dropout_prob: float = 0.0,
                 pre_ln: bool = False,
                 have_relative_position_bias: bool = False,
                 max_relative_position: int = None,
                 attend_to_video: bool = False, use_flash: bool = False):
        super().__init__()
        self.num_attention_heads = num_attention_heads
        self.pre_ln = pre_ln
        self.attend_to_video = attend_to_video
        self.use_flash = use_flash
        use_bias = not exclude_bias
        self.query = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.key = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.value = dense(dim_hidden, dim_hidden, generator, bias=use_bias)
        self.dense = dense(dim_hidden, dim_hidden, generator)
        self.rpe = None
        if have_relative_position_bias:
            if max_relative_position is None:
                raise ValueError("RPE needs max_relative_position")
            self.rpe = RelativePositionBias(
                max_relative_position, num_attention_heads, generator,
                attend_to_video=attend_to_video)
        if hybrid_length:
            self.hybrid_bias = nn.Parameter(
                torch.zeros(num_attention_heads, hybrid_length))
        else:
            self.hybrid_bias = None
        self.LayerNorm = LayerNorm(dim_hidden, eps=layer_norm_eps)
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
        projections. The weights take the input's dtype, as the JAX
        package's fused projection casts its kernel. Returns (q, (k, v)) in
        head form."""
        w = torch.cat([self.query.weight, self.key.weight,
                       self.value.weight]).to(x.dtype)
        b = (None if self.query.bias is None else
             torch.cat([self.query.bias, self.key.bias,
                        self.value.bias]).to(x.dtype))
        q, k, v = nn.functional.linear(x, w, b).chunk(3, dim=-1)
        h = self.num_attention_heads
        return split_heads(q, h), (split_heads(k, h), split_heads(v, h))

    def _make_bias(self, attention_mask, length_q: int, length_k: int,
                   decoding_type: str, n_frames: int,
                   rpe_query_position: int = None, rpe_total_q: int = None):
        """The pad/causal mask (already additive, [B, 1, Lq, Lk]), the
        relative-position bias and the hybrid bias as one additive bias, in
        the reference's order.

        ``rpe_query_position`` (the KV-cached decode step): the
        relative-position table is made for the full query range
        ``rpe_total_q`` and the one row at that position is taken; made with
        ``length_q`` 1 it would anchor every step at position 0.
        """
        bias = attention_mask
        if self.rpe is not None:
            lq = length_q if rpe_query_position is None else rpe_total_q
            if self.attend_to_video:
                rpe_bias = self.rpe(lq, n_frames, bidirectional=True,
                                    tile_to=length_k)
            else:
                rpe_bias = self.rpe(
                    lq, length_k, bidirectional=decoding_type == "NARFormer")
            if rpe_query_position is not None:
                rpe_bias = rpe_bias[:, :, rpe_query_position:
                                    rpe_query_position + 1]
            bias = rpe_bias if bias is None else bias + rpe_bias
        if self.hybrid_bias is not None:
            hb = self.hybrid_bias[None, :, None, :]
            bias = hb if bias is None else bias + hb
        return bias

    def attend(self, q, k, v, bias, input_tensor, return_probs: bool = True):
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
            if bias is not None and bias.shape[0] not in (1, bk):
                raise ValueError(f"bias {tuple(bias.shape)} does not "
                                 f"broadcast over {bk} instances")
            q = q.reshape(bk, bq // bk, nh, dh).transpose(1, 2)
        context, probs = dot_product_attention(
            q, k, v, bias=bias, return_probs=return_probs,
            dropout=self.attn_dropout, use_flash=self.use_flash)
        if grouped:
            context = context.transpose(1, 2).reshape(bq, nh, 1, dh)
            if probs is not None:
                probs = probs.transpose(1, 2).reshape(bq, nh, 1,
                                                      probs.shape[-1])
        context = self.out_dropout(self.dense(merge_heads(context)))
        hidden_states = context + input_tensor
        if not self.pre_ln:
            hidden_states = self.LayerNorm(hidden_states)
        return hidden_states, probs, context

    def forward(self, hidden_states, encoder_hidden_states=None,
                attention_mask=None, decoding_type: str = "ARFormer",
                n_frames: int = 0, return_probs: bool = True):
        input_tensor = hidden_states
        if self.pre_ln:
            hidden_states = self.LayerNorm(hidden_states)
        kv_in = (hidden_states if encoder_hidden_states is None
                 else encoder_hidden_states)
        q = self.project_q(hidden_states)
        k, v = self.project_kv(kv_in)
        bias = self._make_bias(attention_mask, q.shape[2], k.shape[2],
                               decoding_type, n_frames)
        return self.attend(q, k, v, bias, input_tensor,
                           return_probs=return_probs)


class PositionwiseFeedForward(nn.Module):
    """2-layer FFN + dropout + residual + LN, after the residual or with
    ``pre_ln`` on the input (reference ``SubLayers.py:108-152``)."""

    def __init__(self, dim_hidden: int, dim_intermediate: int,
                 hidden_act: str, hidden_dropout_prob: float,
                 layer_norm_eps: float, generator: torch.Generator,
                 pre_ln: bool = False):
        super().__init__()
        self.pre_ln = pre_ln
        self.dense1 = dense(dim_hidden, dim_intermediate, generator)
        self.dense2 = dense(dim_intermediate, dim_hidden, generator)
        self.act = get_activation(hidden_act)
        self.dropout = Dropout(hidden_dropout_prob)
        self.LayerNorm = LayerNorm(dim_hidden, eps=layer_norm_eps)

    def forward(self, hidden_states):
        x = self.LayerNorm(hidden_states) if self.pre_ln else hidden_states
        out = self.dropout(self.dense2(self.act(self.dense1(x))))
        out = out + hidden_states
        return out if self.pre_ln else self.LayerNorm(out)


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


def _check_layer_opt(opt: dict) -> None:
    for key in ("compositional_intra", "compositional_inter",
                "compositional_ffn"):
        if opt.get(key):
            raise unsupported(key, opt[key])
    if opt.get("fusion", "temporal_concat") != "temporal_concat":
        raise unsupported("fusion", opt["fusion"])
    t = opt.get("use_attr_type") or ""
    if opt.get("use_attr") and ("att" in t or "prefix" in t or "pp" in t):
        raise unsupported("use_attr_type", t)


class DecoderLayer(nn.Module):
    """Self-attention -> cross-attention (with the hybrid bias) -> FFN,
    with a full forward and a KV-cached single-token step."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        _check_layer_opt(opt)
        hybrid_length = compute_hybrid_length(opt)
        pre_ln = opt.get("transformer_pre_ln", False)
        common = dict(dim_hidden=opt["dim_hidden"],
                      num_attention_heads=opt["num_attention_heads"],
                      hidden_dropout_prob=opt["hidden_dropout_prob"],
                      attention_probs_dropout_prob=opt[
                          "attention_probs_dropout_prob"],
                      layer_norm_eps=opt["layer_norm_eps"],
                      exclude_bias=opt.get("mha_exclude_bias", False),
                      pre_ln=pre_ln,
                      have_relative_position_bias=opt.get("RPE", False),
                      max_relative_position=opt.get("max_relative_position"),
                      generator=generator)
        self.intra_attention = MultiHeadAttention(**common)
        # the flash kernel pays once the key axis is long (SwinBERT's dense
        # patches reach 1654 keys); the usual ~100 keys stay dense
        upa = opt.get("use_pallas_attention", "auto")
        self.inter_attention = MultiHeadAttention(
            **common, attend_to_video=True,
            hybrid_length=(hybrid_length
                           if opt.get("add_hybrid_attention_bias") else 0),
            use_flash=upa is True or (upa == "auto" and hybrid_length >= 512))
        self.ffn = PositionwiseFeedForward(
            opt["dim_hidden"], opt["intermediate_size"], opt["hidden_act"],
            opt["hidden_dropout_prob"], opt["layer_norm_eps"], generator,
            pre_ln=pre_ln)

    def forward(self, hidden_states, encoder_hidden_states,
                attention_mask=None, encoder_attention_mask=None,
                decoding_type: str = "ARFormer", n_frames: int = 0):
        """Returns (hidden [B, L, D], (intra_probs, inter_probs))."""
        hidden_states, intra_probs, _ = self.intra_attention(
            hidden_states, attention_mask=attention_mask,
            decoding_type=decoding_type)
        hidden_states, inter_probs, _ = self.inter_attention(
            hidden_states, encoder_hidden_states,
            attention_mask=encoder_attention_mask,
            decoding_type=decoding_type, n_frames=n_frames)
        return self.ffn(hidden_states), (intra_probs, inter_probs)

    # ----- KV-cached single-step decode ------------------------------------
    def init_step(self, encoder_hidden_states):
        """Cross-attention K/V, computed once per decode. The flash kernel
        reads them contiguous in head form, so that copy is made here, once,
        and not at every step."""
        k, v = self.inter_attention.project_kv(encoder_hidden_states)
        if self.inter_attention.use_flash:
            k, v = k.contiguous(), v.contiguous()
        return k, v

    def self_qkv(self, token_embs):
        return self.intra_attention.project_qkv(token_embs)

    def step(self, x, position: int, self_kv, inter_kv, self_bias=None,
             cross_bias=None, n_frames: int = 0, q=None):
        """One decode step. x: [B, 1, D]; self_kv: (k, v) [B, H, Lmax, Dh]
        already holding this step's K/V at ``position``, the query's index
        in the full sequence (it selects the relative-position row);
        ``self_bias`` [1, 1, 1, Lmax] masks the future; ``q`` the step's
        self-attention query from ``self_qkv`` (projected here when None).
        Neither attention returns probabilities, which lets the cross
        attention take the flash kernel. Returns the new hidden state
        [B, 1, D]."""
        cache_len = self_kv[0].shape[2]
        if q is None:
            q = self.intra_attention.project_q(x)
        bias = self.intra_attention._make_bias(
            self_bias, 1, cache_len, "ARFormer", n_frames,
            rpe_query_position=position, rpe_total_q=cache_len)
        h, _, _ = self.intra_attention.attend(q, self_kv[0], self_kv[1], bias,
                                              x, return_probs=False)
        qc = self.inter_attention.project_q(h)
        cbias = self.inter_attention._make_bias(
            cross_bias, 1, inter_kv[0].shape[2], "ARFormer", n_frames,
            rpe_query_position=position, rpe_total_q=cache_len)
        h, _, _ = self.inter_attention.attend(qc, inter_kv[0], inter_kv[1],
                                              cbias, h, return_probs=False)
        return self.ffn(h)
