"""Transformer sublayers, the encoder layer and the decoder layer.

Port of ``care_tpu/models/layers.py`` (reference
``models/components/SubLayers.py`` and ``Layers.py``): post- or pre-LN
multi-head attention with the learned hybrid bias over the cross-attention
keys and the relative-position bias, its semantic-composition variant
(``CompositionalLinear`` projections conditioned on the concept
distribution), the sigmoid-gated variant, the position-wise FFN (plain or
compositional), a self-attention encoder layer, and a decoder layer
(self-attention -> {concept-attention placement} -> cross-attention -> FFN)
with a full forward and a KV-cached one-token step whose cross attention
takes the flash kernel once the key axis is long. Masks are additive f32
biases (0 / -1e9).
"""

import torch
from torch import nn

from care_tpu_torch.models.common import (CompositionalLinear, Dropout,
                                          LayerNorm, dense, get_activation)
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
    sublayer's input). ``skip_connection`` False drops the residual and
    ``has_ln`` False the LN (the cross and concept attentions of the
    ``parallel`` placement, whose contexts the decoder layer sums itself).

    ``hybrid_length`` > 0 adds a learned per-head bias ``hybrid_bias``
    [H, Lk] over the key axis (the "HA" of CARE's LSG, reference
    ``Attention.py:47-51,109-111``). ``have_relative_position_bias`` adds a
    ``RelativePositionBias`` table ``rpe``; with ``attend_to_video`` its
    ``n_frames`` columns are tiled over the concatenated streams.
    ``use_flash`` sends a call that asks for no probabilities to the flash
    attention kernel. ``dim_key`` / ``dim_value`` are the widths of the key
    and value inputs (the ``channel_concat`` fusion's concatenated
    streams). ``compositional`` makes every projection a
    ``CompositionalLinear`` of the input and the concept distribution
    ``preds_attr``. ``projections_only`` builds the query, key and value
    projections alone (no output dense, no LN): the pointer's attention,
    which flax builds from ``project_q`` / ``project_kv`` calls only.
    """

    def __init__(self, dim_hidden: int, num_attention_heads: int,
                 hidden_dropout_prob: float, layer_norm_eps: float,
                 generator: torch.Generator, exclude_bias: bool = False,
                 hybrid_length: int = 0,
                 attention_probs_dropout_prob: float = 0.0,
                 pre_ln: bool = False,
                 have_relative_position_bias: bool = False,
                 max_relative_position: int = None,
                 attend_to_video: bool = False, use_flash: bool = False,
                 dim_key: int = None, dim_value: int = None,
                 has_ln: bool = True, skip_connection: bool = True,
                 compositional: bool = False, dim_semantic: int = 500,
                 dim_factor_scale: int = 2, projections_only: bool = False):
        super().__init__()
        self.num_attention_heads = num_attention_heads
        self.pre_ln = pre_ln
        self.skip_connection = skip_connection
        self.attend_to_video = attend_to_video
        self.use_flash = use_flash
        self.compositional = compositional
        dims_in = (dim_hidden, dim_key or dim_hidden, dim_value or dim_hidden,
                   dim_hidden)
        if compositional:
            dim_factor = dim_hidden // dim_factor_scale
            self.query, self.key, self.value, self.dense = (
                CompositionalLinear(dim_hidden, dim_factor, dim_semantic,
                                    dim_in, generator) for dim_in in dims_in)
        else:
            use_bias = not exclude_bias
            self.query = dense(dims_in[0], dim_hidden, generator,
                               bias=use_bias)
            self.key = dense(dims_in[1], dim_hidden, generator, bias=use_bias)
            self.value = dense(dims_in[2], dim_hidden, generator,
                               bias=use_bias)
            self.dense = (None if projections_only
                          else dense(dim_hidden, dim_hidden, generator))
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
        self.LayerNorm = (LayerNorm(dim_hidden, eps=layer_norm_eps)
                          if has_ln and not projections_only else None)
        self.attn_dropout = Dropout(attention_probs_dropout_prob)
        self.out_dropout = Dropout(hidden_dropout_prob)

    def _project(self, layer, x, preds_attr):
        return layer(x, preds_attr) if self.compositional else layer(x)

    def project_q(self, x, preds_attr=None):
        return split_heads(self._project(self.query, x, preds_attr),
                           self.num_attention_heads)

    def project_kv(self, x, preds_attr=None):
        """Keys and values in head form [B, H, L, Dh]."""
        h = self.num_attention_heads
        return (split_heads(self._project(self.key, x, preds_attr), h),
                split_heads(self._project(self.value, x, preds_attr), h))

    def project_qkv(self, x, preds_attr=None):
        """Self-attention q/k/v in one [3D, D] product for the decode step;
        each output element is the same dot product as in the separate
        projections. The weights take the input's dtype, as the JAX
        package's fused projection casts its kernel. The compositional
        projections stay three. Returns (q, (k, v)) in head form."""
        if self.compositional:
            return (self.project_q(x, preds_attr),
                    self.project_kv(x, preds_attr))
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

    def attend(self, q, k, v, bias, input_tensor, return_probs: bool = True,
               preds_attr=None, early_return: bool = False):
        """Attention over pre-projected q/k/v (head form). Returns (hidden,
        probs, context); ``early_return`` returns the context before the
        residual and the LN as the hidden state too.

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
        context = self.out_dropout(
            self._project(self.dense, merge_heads(context), preds_attr))
        if early_return:
            return context, probs, context
        hidden_states = (context + input_tensor if self.skip_connection
                         else context)
        if not self.pre_ln and self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        return hidden_states, probs, context

    def forward(self, hidden_states, encoder_hidden_states=None,
                attention_mask=None, decoding_type: str = "ARFormer",
                n_frames: int = 0, return_probs: bool = True,
                preds_attr=None, early_return: bool = False):
        input_tensor = hidden_states
        if self.pre_ln and self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        kv_in = (hidden_states if encoder_hidden_states is None
                 else encoder_hidden_states)
        q = self.project_q(hidden_states, preds_attr)
        k, v = self.project_kv(kv_in, preds_attr)
        bias = self._make_bias(attention_mask, q.shape[2], k.shape[2],
                               decoding_type, n_frames)
        return self.attend(q, k, v, bias, input_tensor,
                           return_probs=return_probs, preds_attr=preds_attr,
                           early_return=early_return)


class GatedMultiHeadAttention(nn.Module):
    """Sigmoid-gated residual variant (reference ``SubLayers.py:84-105``):
    ``LN(x + sigmoid(gate([x; context])) * context)``, the LN inside
    ``mha`` with ``pre_ln`` and after the gate (``LayerNorm``) otherwise.
    ``mha_kwargs`` are ``MultiHeadAttention``'s. Returns (hidden, (probs,
    gate), context)."""

    def __init__(self, dim_hidden: int, generator: torch.Generator,
                 scalar_gate: bool = False, **mha_kwargs):
        super().__init__()
        pre_ln = mha_kwargs.get("pre_ln", False)
        # the sublayer's own LN only normalises its input (pre-LN): the
        # gated sum takes the LN of its own after the gate otherwise
        self.mha = MultiHeadAttention(dim_hidden, generator=generator,
                                      has_ln=pre_ln, **mha_kwargs)
        self.gate = dense(2 * dim_hidden, 1 if scalar_gate else dim_hidden,
                          generator)
        self.LayerNorm = (None if pre_ln else LayerNorm(
            dim_hidden, eps=mha_kwargs["layer_norm_eps"]))

    def forward(self, hidden_states, **kwargs):
        context, probs, _ = self.mha(hidden_states, early_return=True,
                                     **kwargs)
        gate = torch.sigmoid(self.gate(torch.cat([hidden_states, context],
                                                 dim=-1)))
        out = hidden_states + gate * context
        if self.LayerNorm is not None:
            out = self.LayerNorm(out)
        return out, (probs, gate), context


class PositionwiseFeedForward(nn.Module):
    """2-layer FFN + dropout + residual + LN, after the residual or with
    ``pre_ln`` on the input (reference ``SubLayers.py:108-152``);
    ``compositional`` makes both layers ``CompositionalLinear`` maps
    conditioned on ``preds_attr``."""

    def __init__(self, dim_hidden: int, dim_intermediate: int,
                 hidden_act: str, hidden_dropout_prob: float,
                 layer_norm_eps: float, generator: torch.Generator,
                 pre_ln: bool = False, compositional: bool = False,
                 dim_semantic: int = 500, dim_factor_scale: int = 2):
        super().__init__()
        self.pre_ln = pre_ln
        self.compositional = compositional
        if compositional:
            dim_factor = dim_hidden // dim_factor_scale
            self.dense1 = CompositionalLinear(dim_intermediate, dim_factor,
                                              dim_semantic, dim_hidden,
                                              generator)
            self.dense2 = CompositionalLinear(dim_hidden, dim_factor,
                                              dim_semantic, dim_intermediate,
                                              generator)
        else:
            self.dense1 = dense(dim_hidden, dim_intermediate, generator)
            self.dense2 = dense(dim_intermediate, dim_hidden, generator)
        self.act = get_activation(hidden_act)
        self.dropout = Dropout(hidden_dropout_prob)
        self.LayerNorm = LayerNorm(dim_hidden, eps=layer_norm_eps)

    def forward(self, hidden_states, preds_attr=None):
        x = self.LayerNorm(hidden_states) if self.pre_ln else hidden_states
        if self.compositional:
            x = self.dense2(self.act(self.dense1(x, preds_attr)), preds_attr)
        else:
            x = self.dense2(self.act(self.dense1(x)))
        out = self.dropout(x) + hidden_states
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


def _mha_common(opt: dict, generator: torch.Generator) -> dict:
    return dict(dim_hidden=opt["dim_hidden"],
                num_attention_heads=opt["num_attention_heads"],
                hidden_dropout_prob=opt["hidden_dropout_prob"],
                attention_probs_dropout_prob=opt[
                    "attention_probs_dropout_prob"],
                layer_norm_eps=opt["layer_norm_eps"],
                exclude_bias=opt.get("mha_exclude_bias", False),
                pre_ln=opt.get("transformer_pre_ln", False),
                generator=generator)


def _ffn(opt: dict, generator: torch.Generator, **kwargs):
    return PositionwiseFeedForward(
        opt["dim_hidden"], opt["intermediate_size"], opt["hidden_act"],
        opt["hidden_dropout_prob"], opt["layer_norm_eps"], generator,
        pre_ln=opt.get("transformer_pre_ln", False), **kwargs)


class EncoderLayer(nn.Module):
    """Self-attention + FFN (reference ``Layers.py:16-52``)."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.intra_attention = MultiHeadAttention(**_mha_common(opt,
                                                                generator))
        self.ffn = _ffn(opt, generator)

    def forward(self, hidden_states, attention_mask=None):
        hidden_states, probs, context = self.intra_attention(
            hidden_states, attention_mask=attention_mask)
        return self.ffn(hidden_states), probs, context


ATTR_LAYER_POSITIONS = ("attr2cross", "cross2attr", "parallel")


class DecoderLayer(nn.Module):
    """Self-attention -> {concept-attention placement} -> cross-attention
    (with the hybrid bias) -> FFN, with a full forward and a KV-cached
    single-token step.

    With the LSG ``att`` modes (``use_attr_type`` ``_att`` / ``emb_att``)
    ``attr_attention`` attends over the concept-slot embeddings, placed as
    ``attr_layer_pos`` says (reference ``Layers.py:55-228``): before the
    cross attention (``attr2cross``), after it (``cross2attr``), or beside
    it (``parallel``: both contexts, without residual or LN of their own,
    are summed with the input and normalised by ``LayerNorm``). It is built
    like the cross attention, hybrid bias included, but called over the
    concept slots with no mask, no relative-position row and ``n_frames``
    0, as the JAX package calls it; it never takes the flash kernel.
    """

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.attr_layer_pos = opt.get("attr_layer_pos", "cross2attr")
        if self.attr_layer_pos not in ATTR_LAYER_POSITIONS:
            raise ValueError(f"attr_layer_pos {self.attr_layer_pos!r}")
        common = _mha_common(opt, generator)
        comp = dict(dim_semantic=opt.get("attribute_prediction_k", 500),
                    dim_factor_scale=opt.get("dim_factor_scale", 2))
        rpe = dict(have_relative_position_bias=opt.get("RPE", False),
                   max_relative_position=opt.get("max_relative_position"))
        self.intra_attention = MultiHeadAttention(
            **common, **comp, **rpe,
            compositional=opt.get("compositional_intra", False))

        if opt.get("fusion", "temporal_concat") == "channel_concat":
            dim_key = opt["dim_hidden"] * len(opt["modality"])
        else:
            dim_key = opt["dim_hidden"]
        hybrid_length = compute_hybrid_length(opt)
        parallel = self.attr_layer_pos == "parallel"
        cross = dict(
            **common, **comp, **rpe, dim_key=dim_key, dim_value=dim_key,
            attend_to_video=True, has_ln=not parallel,
            skip_connection=not parallel,
            hybrid_length=(hybrid_length
                           if opt.get("add_hybrid_attention_bias") else 0),
            compositional=opt.get("compositional_inter", False))
        # the flash kernel pays once the key axis is long (SwinBERT's dense
        # patches reach 1654 keys); the usual ~100 keys stay dense
        upa = opt.get("use_pallas_attention", "auto")
        self.inter_attention = MultiHeadAttention(
            **cross,
            use_flash=upa is True or (upa == "auto" and hybrid_length >= 512))
        self.has_attr_attention = bool(
            opt.get("use_attr") and "att" in (opt.get("use_attr_type") or ""))
        self.attr_attention = (MultiHeadAttention(**cross)
                               if self.has_attr_attention else None)
        # the parallel placement's LN over the summed contexts (unused,
        # hence absent, without a concept attention)
        self.LayerNorm = None
        if parallel and self.has_attr_attention:
            self.LayerNorm = LayerNorm(opt["dim_hidden"],
                                       eps=opt["layer_norm_eps"])
        self.ffn = _ffn(opt, generator,
                        compositional=opt.get("compositional_ffn", False),
                        **comp)

    def _placed(self, where: str) -> bool:
        return self.has_attr_attention and self.attr_layer_pos == where

    def _run_attr(self, hidden_states, semantic_embs, preds_attr):
        return self.attr_attention(hidden_states,
                                   encoder_hidden_states=semantic_embs,
                                   preds_attr=preds_attr)

    def forward(self, hidden_states, encoder_hidden_states,
                attention_mask=None, encoder_attention_mask=None,
                semantic_embs=None, preds_attr=None,
                decoding_type: str = "ARFormer", n_frames: int = 0):
        """Returns (hidden [B, L, D], probs, contexts, embs): the tuples
        of the sublayers in the order they ran, as the JAX package's
        layer returns them."""
        hidden_states, intra_probs, text_context = self.intra_attention(
            hidden_states, attention_mask=attention_mask,
            decoding_type=decoding_type, preds_attr=preds_attr)
        probs, contexts, embs = ((intra_probs,), (text_context,),
                                 (hidden_states,))
        if self._placed("attr2cross"):
            hidden_states, p, c = self._run_attr(hidden_states, semantic_embs,
                                                 preds_attr)
            probs, contexts, embs = (probs + (p,), contexts + (c,),
                                     embs + (hidden_states,))
        cross = dict(encoder_hidden_states=encoder_hidden_states,
                     attention_mask=encoder_attention_mask,
                     decoding_type=decoding_type, n_frames=n_frames,
                     preds_attr=preds_attr)
        if self._placed("parallel"):
            _, inter_probs, inter_context = self.inter_attention(
                hidden_states, **cross)
            _, attr_probs, attr_context = self._run_attr(
                hidden_states, semantic_embs, preds_attr)
            hidden_states = self.LayerNorm(hidden_states + inter_context
                                           + attr_context)
            probs += (inter_probs, attr_probs)
            contexts += (inter_context, attr_context)
        else:
            hidden_states, p, c = self.inter_attention(hidden_states,
                                                       **cross)
            probs, contexts = probs + (p,), contexts + (c,)
        embs += (hidden_states,)
        if self._placed("cross2attr"):
            hidden_states, p, c = self._run_attr(hidden_states, semantic_embs,
                                                 preds_attr)
            probs, contexts, embs = (probs + (p,), contexts + (c,),
                                     embs + (hidden_states,))
        return self.ffn(hidden_states, preds_attr), probs, contexts, embs

    # ----- KV-cached single-step decode ------------------------------------
    def init_step(self, encoder_hidden_states, semantic_embs=None,
                  preds_attr=None):
        """Cross-attention K/V, and the concept attention's over the
        concept slots, computed once per decode at the instances' rows
        (``preds_attr`` [B]). The flash kernel reads the cross K/V
        contiguous in head form, so that copy is made here, once, and not
        at every step. Returns (inter_kv, attr_kv or None)."""
        k, v = self.inter_attention.project_kv(encoder_hidden_states,
                                               preds_attr)
        if self.inter_attention.use_flash:
            k, v = k.contiguous(), v.contiguous()
        attr_kv = None
        if self.has_attr_attention:
            attr_kv = self.attr_attention.project_kv(semantic_embs,
                                                     preds_attr)
        return (k, v), attr_kv

    def prefill_self_kv(self, token_embs, preds_attr=None):
        """Self-attention K/V of a block of known tokens (the G-LSG concept
        prefix)."""
        return self.intra_attention.project_kv(token_embs, preds_attr)

    def self_qkv(self, token_embs, preds_attr=None):
        return self.intra_attention.project_qkv(token_embs, preds_attr)

    def _step_attr(self, h, attr_kv, preds_attr):
        qa = self.attr_attention.project_q(h, preds_attr)
        bias = self.attr_attention._make_bias(None, 1, attr_kv[0].shape[2],
                                              "ARFormer", 0)
        return self.attr_attention.attend(qa, attr_kv[0], attr_kv[1], bias,
                                          h, return_probs=False,
                                          preds_attr=preds_attr)

    def step(self, x, position: int, self_kv, inter_kv, attr_kv=None,
             self_bias=None, cross_bias=None, preds_attr=None,
             n_frames: int = 0, q=None):
        """One decode step. x: [B, 1, D]; self_kv: (k, v) [B, H, Lmax, Dh]
        already holding this step's K/V at ``position``, the query's index
        in the full sequence (it selects the relative-position row);
        ``self_bias`` [1, 1, 1, Lmax] masks the future; ``q`` the step's
        self-attention query from ``self_qkv`` (projected here when None);
        ``preds_attr`` at the rows of ``x``. The cross and concept K/V sit
        at the instances' rows (``attend`` folds the beams into the query
        rows). No attention returns probabilities, which lets the cross
        attention take the flash kernel. Returns the new hidden state
        [B, 1, D]."""
        cache_len = self_kv[0].shape[2]
        if q is None:
            q = self.intra_attention.project_q(x, preds_attr)
        bias = self.intra_attention._make_bias(
            self_bias, 1, cache_len, "ARFormer", n_frames,
            rpe_query_position=position, rpe_total_q=cache_len)
        h, _, _ = self.intra_attention.attend(q, self_kv[0], self_kv[1], bias,
                                              x, return_probs=False,
                                              preds_attr=preds_attr)
        if self._placed("attr2cross"):
            h, _, _ = self._step_attr(h, attr_kv, preds_attr)
        qc = self.inter_attention.project_q(h, preds_attr)
        cbias = self.inter_attention._make_bias(
            cross_bias, 1, inter_kv[0].shape[2], "ARFormer", n_frames,
            rpe_query_position=position, rpe_total_q=cache_len)
        cross_h, _, inter_context = self.inter_attention.attend(
            qc, inter_kv[0], inter_kv[1], cbias, h, return_probs=False,
            preds_attr=preds_attr)
        if self._placed("parallel"):
            _, _, attr_context = self._step_attr(h, attr_kv, preds_attr)
            h = self.LayerNorm(h + inter_context + attr_context)
        else:
            h = cross_h
        if self._placed("cross2attr"):
            h, _, _ = self._step_attr(h, attr_kv, preds_attr)
        return self.ffn(h, preds_attr)
