"""The Transformer decoder: full forward and KV-cached incremental decode.

Port of ``care_tpu/models/decoders.py:TransformerDecoder`` (reference
``models/Decoder/Transformer.py``) and of its two-stage NACF subclass
``TwoStageTransformerDecoder``. Under ``decoding_type: NARFormer`` the
self-attention sees every non-PAD token (no causal term) and the token
embeddings take the NAR input enhancement (``enhance_input``: 1 resamples
the encoder states to each row's length, 2 adds their mean). In every
G-LSG mode: the GSG vector added to every token (``emb``) or prepended as
one prefix token (``pp_emb``), the LSG concept slots as cross-attention
keys (``concat``), as a concept-attention sublayer (``att``) or as a
prefix of the sequence (``prefix``, with the prefix-mask surgery),
category embeddings, the compositional projections conditioned on
``preds_attr``, post- or pre-LN, with or without relative-position biases,
and the ``TAP_pos`` / ``TAP_ln`` text post-processing of the embeddings
the decoder-side concept losses read. Masks are additive 0/-1e9 biases
computed from the token ids.

The RNN captioners (``care_tpu/models/decoders.py:412-910``, reference
``RNN_single_layer.py`` and ``RNN_multi_layers.py``): SA-LSTM's
``SingleLayerRNNDecoder`` (its ``VOERNNDecoder`` form starts from the raw
mean features) and the two-cell ``TopDownAttentionRNNDecoder``, on the
torch-layout cells ``LSTMCellTorch`` / ``GRUCellTorch``, with additive,
multi-level or multi-head attention over the encoder states, the GSG vector
added to every word, the LSG concept slots attended under the local flag,
and the one-hot category appended to the cell's input. Training runs a
Python loop over time with scheduled sampling; serving steps the cell over
a carry that the translator reorders with the beams.
"""

from typing import Any, Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch import constants
from care_tpu_torch.models.common import (Dense, Dropout, LayerNorm, dense,
                                          flax_init_, xavier_param)
from care_tpu_torch.models.embeddings import Embeddings
from care_tpu_torch.models.layers import DecoderLayer, MultiHeadAttention
from care_tpu_torch.models.predictors import TextPostProcesser
from care_tpu_torch.ops.attention import NEG_INF


def key_pad_bias(seq_k, len_q: int):
    """Additive bias masking PAD keys: [B, 1, len_q, len_k]."""
    pad = seq_k == constants.PAD
    bias = torch.zeros(pad.shape, device=seq_k.device).masked_fill(pad,
                                                                   NEG_INF)
    return bias[:, None, None, :].expand(seq_k.shape[0], 1, len_q,
                                         seq_k.shape[1])


def causal_bias(len_s: int, watch: int = 0, device=None):
    """Additive causal bias [1, 1, len_s, len_s]; optional `watch` window."""
    i = torch.arange(len_s, device=device)[:, None]
    j = torch.arange(len_s, device=device)[None, :]
    future = j > i
    if watch > 0:
        future = future | (j <= i - watch)
    bias = torch.zeros((len_s, len_s), device=device).masked_fill(future,
                                                                  NEG_INF)
    return bias[None, None]


def nar_resample(source, tgt_tokens):
    """Resample the encoder states [B, T, D] to each row's target length
    (vectorised reference ``Transformer.py:50-63``): position j of a row
    of n tokens takes frame ``int(j * T / n)``. The scale is an f32
    quotient, as in the JAX package: an f64 scale, or torch's ``T / n``
    of a Python number (the reciprocal of n times T), can land one frame
    off."""
    pad = tgt_tokens == constants.PAD
    length = (~pad).sum(dim=-1)
    seq_len = tgt_tokens.shape[1]
    src_len = source.shape[1]
    scale = torch.div(torch.full(length.shape, float(src_len),
                                 device=length.device),
                      torch.clamp_min(length, 1).to(torch.float32))
    pos = torch.arange(seq_len, device=tgt_tokens.device,
                       dtype=torch.int32)[None, :]
    idx = (pos * scale[:, None]).to(torch.int64)
    idx = torch.clamp_max(idx, src_len - 1)
    return torch.gather(source, 1,
                        idx[:, :, None].expand(-1, -1, source.shape[-1]))


def prefix_mask_surgery(bias, prefix_len: int):
    """Prepend concept-prefix rows/cols to a self-attention bias
    (reference ``Transformer.py:131-152``): every word position may attend
    to all prefix slots; each prefix slot attends only to itself."""
    b, _, len_q, len_k = bias.shape
    dev = bias.device
    left = torch.zeros((b, 1, len_q, prefix_len), device=dev)
    bias = torch.cat([left, bias], dim=3)
    eye = torch.eye(prefix_len, device=dev) > 0
    top_prefix = torch.full((prefix_len, prefix_len), NEG_INF,
                            device=dev).masked_fill(eye, 0.0)
    top_words = torch.full((prefix_len, len_k), NEG_INF, device=dev)
    top = torch.cat([top_prefix, top_words], dim=1)[None, None]
    top = top.expand(b, 1, prefix_len, prefix_len + len_k)
    return torch.cat([top, bias], dim=2)


class TransformerDecoder(nn.Module):

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt.get("enhance_input", 2) not in (0, 1, 2):
            raise ValueError("enhance_input should be 0, 1 or 2")
        self.opt = opt
        self.decoding_type = opt["decoding_type"]
        self.enhance_input = opt.get("enhance_input", 2)
        self.TPP = (TextPostProcesser(opt, generator)
                    if opt.get("TAP_pos") or opt.get("TAP_ln") else None)
        self.embedding = Embeddings(opt, generator)
        self.num_layers = opt["num_hidden_layers_decoder"]
        for i in range(self.num_layers):
            self.add_module(f"layer_{i}", DecoderLayer(opt, generator))
        # pre-LN layers leave their output unnormalised: one LN closes the
        # stack
        self.LayerNorm = None
        if opt.get("transformer_pre_ln", False):
            self.LayerNorm = LayerNorm(opt["dim_hidden"],
                                       eps=opt["layer_norm_eps"])
        self.dropout = Dropout(opt["hidden_dropout_prob"])
        t = opt.get("use_attr_type") or ""
        self.concept_prefix = bool(opt.get("use_attr")) and "prefix" in t
        self.prefix_len = 0
        if self.concept_prefix:
            self.prefix_len = opt["use_attr_topk"]
        elif opt.get("use_attr") and "pp" in t:
            self.prefix_len = 1

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    # ----- embedding helpers -------------------------------------------------
    def get_sentence_embeddings(self, input_ids, average_pooling: bool = True):
        embs = self.embedding.embed_tokens(input_ids)
        if average_pooling:
            # the JAX package's mask compares the embeddings with PAD
            mask = (embs != constants.PAD).float()
            n_words = mask.sum(dim=1, keepdim=True)
            embs = (embs * mask).sum(dim=1) / n_words.squeeze(1)
        return embs if self.TPP is None else self.TPP(embs)

    def get_attr_embeddings(self, attr_input_ids):
        embs = self.embedding.embed_tokens(attr_input_ids)
        return embs if self.TPP is None else self.TPP(embs)

    def _self_attention_bias(self, input_ids):
        bias = key_pad_bias(input_ids, input_ids.shape[1])
        if self.decoding_type != "NARFormer":
            bias = bias + causal_bias(input_ids.shape[1],
                                      self.opt.get("watch", 0),
                                      input_ids.device)
        if self.prefix_len:
            bias = prefix_mask_surgery(bias, self.prefix_len)
        return bias

    def forward(self, input_ids, encoder_hidden_states, semantic_embs=None,
                semantic_hidden_states=None, preds_attr=None, category=None,
                category_embs=None, attr_input_ids=None,
                collect_aux: bool = True,
                return_input_embs: bool = False,
                **unused) -> Dict[str, Any]:
        """Full forward over ``input_ids`` [B, L]. Returns
        {"hidden_states": [B, L', D]} (L' counts the prefix slots of the
        prefix modes) and, with ``collect_aux``, the JAX package's aux
        entries: every layer's hidden states and attention probabilities,
        the last layer's contexts and sublayer outputs, the input and
        sentence embeddings, the concept-attention probabilities (with
        ``use_attr``) and the ``attr_input_ids`` embeddings.
        ``return_input_embs`` returns the embedded input (with the concept
        prefix) alone."""
        opt = self.opt
        if isinstance(encoder_hidden_states, (list, tuple)):
            if len(encoder_hidden_states) != 1:
                raise ValueError("the decoder takes one fused stream")
            encoder_hidden_states = encoder_hidden_states[0]
        attention_bias = self._self_attention_bias(input_ids)
        additional_feats = None
        if self.decoding_type == "NARFormer":
            if self.enhance_input == 1:
                additional_feats = nar_resample(encoder_hidden_states,
                                                input_ids)
            elif self.enhance_input == 2:
                additional_feats = encoder_hidden_states.mean(
                    dim=1, keepdim=True).expand(
                        input_ids.shape[0], input_ids.shape[1],
                        encoder_hidden_states.shape[-1])
        input_embs = self.embedding(
            input_ids, semantic_hidden_states=semantic_hidden_states,
            category=category, category_embs=category_embs,
            additional_feats=additional_feats)
        original_input_embs = input_embs
        if self.concept_prefix:
            input_embs = torch.cat([semantic_embs, input_embs], dim=1)
        if return_input_embs:
            return input_embs
        # every encoder position is visible (the reference builds an
        # all-ones source mask), so the cross attention needs no mask
        all_hidden_states = [input_embs]
        all_intra, all_inter, all_attr = (), (), ()
        for layer in self.layers:
            hidden_states, probs, contexts, embs = layer(
                all_hidden_states[-1], encoder_hidden_states,
                attention_mask=attention_bias, semantic_embs=semantic_embs,
                preds_attr=preds_attr, decoding_type=self.decoding_type,
                n_frames=opt["n_frames"])
            # unpacked as the JAX package unpacks them: with attr2cross the
            # second entry is the concept attention's
            intra_probs, inter_probs, *rest = probs
            text_context, context, *_ = contexts
            self_embs, cross_embs, *_ = embs
            all_hidden_states.append(hidden_states)
            all_intra += (intra_probs,)
            all_inter += (inter_probs,)
            if rest:
                all_attr += (rest[0],)
        hidden_states = all_hidden_states[-1]
        if self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        outputs: Dict[str, Any] = {"hidden_states": self.dropout(hidden_states)}
        if collect_aux:
            outputs.update({
                "all_hidden_states": all_hidden_states,
                "all_intra_attentions": all_intra,
                "all_inter_attentions": all_inter,
                "attention_probs": all_inter[-1].mean(dim=1),
                "context": context,
                "text_context": text_context,
                "self_embs": self_embs,
                "cross_embs": cross_embs,
                "input_embs": original_input_embs,
                "input_embs_exclude_bos": original_input_embs[:, 1:, :],
                "sentence_embs": self.get_sentence_embeddings(
                    input_ids, average_pooling=False),
            })
            if opt.get("use_attr"):
                outputs["attr_attention_probs"] = all_attr
            if attr_input_ids is not None:
                outputs["attr_embs"] = self.get_attr_embeddings(
                    attr_input_ids)
        return outputs

    # ----- KV-cached incremental decoding ------------------------------------
    def init_decode_state(self, batch_size: int, max_len: int,
                          encoder_hidden_states, semantic_embs=None,
                          semantic_hidden_states=None, preds_attr=None,
                          category=None, category_embs=None,
                          beam_size: int = 1) -> Dict[str, Any]:
        """The decode cache: cross-attention (and concept-attention) K/V
        per layer + an empty self-attention K/V cache, with the concept
        prefix of the ``prefix`` / ``pp_emb`` modes prefilled.

        With ``beam_size`` > 1 the encoder-side inputs arrive un-enlarged
        ([B, ...]). Only the per-row state (the self K/V cache, and the GSG
        vector, category and ``preds_attr`` the step's embedding and
        projections take) is laid out at ``batch_size`` (= B*beam) rows,
        instance-major. Cross and concept K/V stay at [B]: ``attend`` folds
        the beam into the query rows. The prefix slots see only themselves,
        so each layer's prefix K/V come from running the layer over the
        prefix block at [B] with a diagonal mask; an instance's beams get
        the same rows.
        """
        if isinstance(encoder_hidden_states, (list, tuple)):
            encoder_hidden_states = encoder_hidden_states[0]
        opt = self.opt
        dh = opt["dim_hidden"] // opt["num_attention_heads"]
        cache_len = max_len + self.prefix_len

        def rep(x):
            if x is None or beam_size == 1:
                return x
            return x.repeat_interleave(beam_size, dim=0)

        layers_state = []
        for layer in self.layers:
            inter_kv, attr_kv = layer.init_step(
                encoder_hidden_states, semantic_embs=semantic_embs,
                preds_attr=preds_attr)
            # this process's heads on a model axis
            shape = (batch_size, layer.intra_attention.local_heads(),
                     cache_len, dh)
            layers_state.append({
                "inter_kv": inter_kv, "attr_kv": attr_kv,
                "self_k": encoder_hidden_states.new_zeros(shape),
                "self_v": encoder_hidden_states.new_zeros(shape)})
        state = {"layers": layers_state,
                 "aux": {"category": rep(category),
                         "category_embs": rep(category_embs),
                         "semantic_hidden_states": rep(semantic_hidden_states),
                         "preds_attr": rep(preds_attr)}}
        if self.prefix_len:
            if self.concept_prefix:
                x = semantic_embs
            else:
                x = self.embedding.embed_pp_prefix(
                    semantic_hidden_states, category=category,
                    category_embs=category_embs)
            p = self.prefix_len
            eye = torch.eye(p, dtype=torch.bool, device=x.device)
            diag = torch.full((p, p), NEG_INF, device=x.device).masked_fill(
                eye, 0.0)[None, None]
            for layer, st in zip(self.layers, layers_state):
                k, v = layer.prefill_self_kv(x, preds_attr)
                st["self_k"][:, :, :p] = rep(k).to(st["self_k"].dtype)
                st["self_v"][:, :, :p] = rep(v).to(st["self_v"].dtype)
                x, _, _, _ = layer(
                    x, encoder_hidden_states, attention_mask=diag,
                    semantic_embs=semantic_embs, preds_attr=preds_attr,
                    n_frames=opt["n_frames"])
        return state

    def decode_step(self, token_ids, position: int, state):
        """One AR step. token_ids: [B] int; position: the 0-based word
        position. Writes this step's self-attention K/V into the cache in
        place and returns (hidden [B, D], state)."""
        aux = state["aux"]
        cache_len = state["layers"][0]["self_k"].shape[2]
        dev = token_ids.device
        # the words of the prefix modes are embedded without the semantic
        # term: the prefix carries it and sits in the cache already
        x = self.embedding(
            token_ids[:, None],
            semantic_hidden_states=(None if self.prefix_len
                                    else aux["semantic_hidden_states"]),
            position_ids=torch.full((token_ids.shape[0], 1), position,
                                    device=dev),
            category=aux["category"], category_embs=aux["category_embs"])
        cache_pos = position + self.prefix_len
        # visible: the prefix slots and the words up to this one
        visible = torch.arange(cache_len, device=dev) <= cache_pos
        self_bias = torch.zeros(cache_len, device=dev)
        self_bias = self_bias.masked_fill(~visible, NEG_INF)[None, None, None]
        preds_attr = aux["preds_attr"]
        h = x
        for layer, st in zip(self.layers, state["layers"]):
            q, (k, v) = layer.self_qkv(h, preds_attr)
            st["self_k"][:, :, cache_pos:cache_pos + 1] = k
            st["self_v"][:, :, cache_pos:cache_pos + 1] = v
            # the relative-position rows select by the position in the
            # full (prefix + words) sequence
            h = layer.step(h, cache_pos, (st["self_k"], st["self_v"]),
                           st["inter_kv"], attr_kv=st["attr_kv"],
                           self_bias=self_bias, preds_attr=preds_attr,
                           n_frames=self.opt["n_frames"], q=q)
        if self.LayerNorm is not None:
            h = self.LayerNorm(h)
        return h[:, 0, :], state


class TwoStageTransformerDecoder(TransformerDecoder):
    """The NACF decoder (reference ``Transformer.py:271-287``): given a
    list of 2 or 3 token sequences, a visual-word pass over the first (all
    ``<vis>``) and a masked-language pass over the second, with
    ``hidden_states`` the list of both passes' states; a third sequence
    gives ``input_embs`` and ``sentence_embs``. A single sequence is one
    plain forward."""

    def forward(self, input_ids, *args, **kwargs):
        if not isinstance(input_ids, (list, tuple)):
            return super().forward(input_ids, *args, **kwargs)
        if len(input_ids) not in (2, 3):
            raise ValueError(f"{len(input_ids)} token sequences; the "
                             f"two-stage decoder takes 2 or 3")
        outputs1 = super().forward(input_ids[0], *args, **kwargs)
        outputs2 = super().forward(input_ids[1], *args, **kwargs)
        outputs2["hidden_states"] = [outputs1["hidden_states"],
                                     outputs2["hidden_states"]]
        if len(input_ids) == 3:
            outputs2["input_embs"] = super().forward(
                input_ids[2], *args, **dict(kwargs, return_input_embs=True))
            outputs2["sentence_embs"] = self.get_sentence_embeddings(
                input_ids[2], average_pooling=False)
        return outputs2


# ---------------------------------------------------------------------------
# RNN decoders
# ---------------------------------------------------------------------------

def _rnn_uniform_(tensor, cell_features: int, generator: torch.Generator):
    """torch's LSTMCell / GRUCell init, U(-1/sqrt(H), 1/sqrt(H)), in place
    (the reference's xavier pass touches only Linear and Embedding
    modules, so its cells keep this default)."""
    k = 1.0 / cell_features ** 0.5
    with torch.no_grad():
        tensor.uniform_(-k, k, generator=generator)


def rnn_dense(dim_in: int, dim_out: int, cell_features: int,
              generator: torch.Generator, forget_offset: float = 0.0
              ) -> Dense:
    """A cell's ``Dense`` with the torch cell init; ``forget_offset`` is
    added to the forget chunk [H:2H] of its bias."""
    layer = Dense(dim_in, dim_out)
    _rnn_uniform_(layer.weight, cell_features, generator)
    _rnn_uniform_(layer.bias, cell_features, generator)
    if forget_offset:
        with torch.no_grad():
            layer.bias[cell_features:2 * cell_features] += forget_offset
    return layer


class LSTMCellTorch(nn.Module):
    """``torch.nn.LSTMCell``'s semantics (gate order i, f, g, o) on two
    ``Dense`` maps ``ih`` and ``hh``. The reference adds 1 to the forget
    chunk of both biases after init, which their init does here."""

    def __init__(self, dim_in: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.ih = rnn_dense(dim_in, 4 * features, features, generator, 1.0)
        self.hh = rnn_dense(features, 4 * features, features, generator, 1.0)

    def forward(self, carry, inputs):
        h, c = carry
        i, f, g, o = (self.ih(inputs) + self.hh(h)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return new_h, new_c


class GRUCellTorch(nn.Module):
    """``torch.nn.GRUCell``'s semantics: r and z from ``ih_rz`` +
    ``hh_rz``, n = tanh(ih_n(x) + r * hh_n(h)) with r multiplying
    ``hh_n``'s output and its bias."""

    def __init__(self, dim_in: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        self.ih_rz = rnn_dense(dim_in, 2 * features, features, generator)
        self.hh_rz = rnn_dense(features, 2 * features, features, generator)
        self.ih_n = rnn_dense(dim_in, features, features, generator)
        self.hh_n = rnn_dense(features, features, features, generator)

    def forward(self, carry, inputs):
        r, z = torch.sigmoid(self.ih_rz(inputs)
                             + self.hh_rz(carry)).chunk(2, dim=-1)
        n = torch.tanh(self.ih_n(inputs) + r * self.hh_n(carry))
        return (1 - z) * n + z * carry


class OptimizedLSTMCellTorch(nn.Module):
    """flax's ``OptimizedLSTMCell`` (the ``has_retrieval_rnn`` refiner of
    the text stream), which is not ``torch.nn.LSTMCell``: per gate a
    bias-free input map ``i{i,f,g,o}`` and a recurrent map ``h{i,f,g,o}``
    with a bias, lecun-normal input and orthogonal recurrent kernels, zero
    biases and no forget-gate offset. The carry is (c, h), as flax's."""

    def __init__(self, dim_in: int, features: int,
                 generator: torch.Generator):
        super().__init__()
        for gate in "ifgo":
            inp = flax_init_(Dense(dim_in, features, bias=False), generator)
            rec = Dense(features, features)
            with torch.no_grad():
                nn.init.orthogonal_(rec.weight, generator=generator)
                rec.bias.zero_()
            # "if" is a keyword: the maps are registered by name
            self.add_module(f"i{gate}", inp)
            self.add_module(f"h{gate}", rec)

    def forward(self, carry, inputs):
        c, h = carry
        maps = [getattr(self, f"{side}{gate}") for side in "ih"
                for gate in "ifgo"]
        # flax promotes the operands to one dtype
        dtype = torch.promote_types(inputs.dtype, maps[0].weight.dtype)
        dense_i = F.linear(inputs.to(dtype), torch.cat(
            [m.weight for m in maps[:4]]).to(dtype))
        dense_h = F.linear(h.to(dtype),
                           torch.cat([m.weight for m in maps[4:]]).to(dtype),
                           torch.cat([m.bias for m in maps[4:]]).to(dtype))
        i, f, g, o = (dense_h + dense_i).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


def _bmm_context(probs, feats):
    """sum_l probs[b, l] * feats[b, l, :] in the promoted dtype."""
    dtype = torch.promote_types(probs.dtype, feats.dtype)
    return torch.bmm(probs[:, None, :].to(dtype), feats.to(dtype))[:, 0]


class AdditiveAttention(nn.Module):
    """Bahdanau attention with a loop over the feature lists (reference
    ``Attention.py:134-206``): one ``linear1_f_<i>`` per list (one for all
    with ``feats_share_weights``), ``linear1_h`` of the query, the
    bias-free ``linear2`` to one logit a key, and with ``hybrid_length`` a
    learned ``hybrid_bias`` [1, hybrid_length] added to the logits.
    Returns (the lists' contexts concatenated, their probabilities stacked
    on axis 1), or with ``return_raw`` the two lists."""

    def __init__(self, dim_hidden: int, dim_mid: int, dim_feats: int,
                 generator: torch.Generator, n_feats: int = 1,
                 feats_share_weights: bool = False, hybrid_length: int = 0):
        super().__init__()
        self.n_layers = 1 if feats_share_weights else n_feats
        for i in range(self.n_layers):
            self.add_module(f"linear1_f_{i}",
                            dense(dim_feats, dim_mid, generator))
        self.linear1_h = dense(dim_hidden, dim_mid, generator)
        self.linear2 = dense(dim_mid, 1, generator, bias=False)
        self.hybrid_bias = (nn.Parameter(torch.zeros(1, hybrid_length))
                            if hybrid_length else None)

    def forward(self, hidden_states, feats, return_raw: bool = False):
        if not isinstance(feats, (list, tuple)):
            feats = [feats]
        emb_h = self.linear1_h(hidden_states)[:, None, :]
        probs, context = [], []
        for i, inputs in enumerate(feats):
            layer = getattr(self, f"linear1_f_{min(i, self.n_layers - 1)}")
            logits = self.linear2(torch.tanh(emb_h + layer(inputs)))[:, :, 0]
            if self.hybrid_bias is not None:
                logits = logits + self.hybrid_bias
            p = torch.softmax(logits, dim=1)
            probs.append(p)
            context.append(_bmm_context(p, inputs))
        if return_raw:
            return context, probs
        return torch.cat(context, dim=1), torch.stack(probs, dim=1)


class MultiLevelAttention(nn.Module):
    """Temporal attention per feature list, then attention over the lists'
    contexts (reference ``Attention.py:209-237``). Returns the second
    stage's context and the temporal probabilities stacked on axis 1, as
    the JAX package keeps them."""

    def __init__(self, dim_hidden: int, dim_mid: int, dim_feats: int,
                 n_feats: int, generator: torch.Generator,
                 feats_share_weights: bool = False):
        super().__init__()
        self.temporal_aware_attention = AdditiveAttention(
            dim_hidden, dim_mid, dim_feats, generator, n_feats=n_feats,
            feats_share_weights=feats_share_weights)
        self.modality_aware_attention = AdditiveAttention(
            dim_hidden, dim_mid, dim_feats, generator)

    def forward(self, hidden_states, feats):
        context, probs = self.temporal_aware_attention(hidden_states, feats,
                                                       return_raw=True)
        ctx2, _ = self.modality_aware_attention(
            hidden_states, torch.stack(context, dim=1), return_raw=True)
        return ctx2[0], torch.stack(probs, dim=1)


def _word_embeddings(opt: dict, generator: torch.Generator) -> nn.Parameter:
    """The RNN decoders' word table (reference ``RNN_single_layer.py:58-69``):
    a table read from the local ``.npy`` file ``pretrained_embs_path``
    (frozen by the optimizer unless ``train_emb``), else xavier with the
    PAD row zeroed."""
    shape = (opt["vocab_size"], opt["dim_hidden"])
    if opt.get("pretrained_embs_path", ""):
        table = np.load(opt["pretrained_embs_path"]).astype(np.float32)
        if table.shape != shape:
            raise ValueError(f"pretrained embeddings {table.shape}, the "
                             f"decoder's table is {shape}")
        return nn.Parameter(torch.from_numpy(table))
    return xavier_param(shape, generator, zero_pad_row=True)


def _mean_video_features(encoder_hidden_states):
    """The mean over the feature lists, then over time: [B, D]."""
    if not isinstance(encoder_hidden_states, (list, tuple)):
        encoder_hidden_states = [encoder_hidden_states]
    return torch.stack(list(encoder_hidden_states), dim=0).mean(dim=0).mean(
        dim=1)


class _RNNDecoderBase(nn.Module):
    """What both RNN decoders share: the word table and its LN, the
    attention over the encoder states (``rnn_use_mha``: the multi-head
    sublayer with the step's query; ``with_multileval_attention``: the
    multi-level one; else additive, with the hybrid bias), the concept
    flags (``emb``: the GSG vector added to every word; ``att``: additive
    attention over the concept slots), dropout and the one-hot category.
    Submodules carry the flax tree's names."""

    def __init__(self, opt: dict, generator: torch.Generator,
                 multilevel: bool):
        super().__init__()
        if opt.get("with_category") and opt.get("use_category_embs"):
            # care_tpu hands such a decoder ``category_embs`` and no
            # ``category``, and its cell input then fails to concatenate
            raise ValueError("use_category_embs is an option of the "
                             "Transformer decoders; an RNN decoder takes the "
                             "one-hot category")
        self.opt = opt
        D = opt["dim_hidden"]
        self.rnn_type = opt.get("rnn_type", "lstm").lower()
        if self.rnn_type not in ("lstm", "gru"):
            raise ValueError(f"unknown rnn_type `{self.rnn_type}`")
        self.cell_cls = (LSTMCellTorch if self.rnn_type == "lstm"
                         else GRUCellTorch)
        self.word_embeddings = _word_embeddings(opt, generator)
        self.LayerNorm = LayerNorm(D, eps=opt.get("layer_norm_eps", 1e-12))

        modality = opt.get("modality_for_decoder") or opt["modality"]
        num_modality = len(modality)
        fusion = opt["fusion"]
        # the encoder hands a list of streams only without fusion
        n_lists = num_modality if fusion == "none" else 1
        self.dim_feats = D * (num_modality if fusion == "channel_concat"
                              else 1)
        t = opt.get("use_attr_type") or ""
        self.semantic_global_flag = bool(opt.get("use_attr")) and "emb" in t
        self.semantic_local_flag = bool(opt.get("use_attr")) and "att" in t
        hybrid_length = (opt["n_frames"] * num_modality
                         + opt.get("use_attr_topk", 30)
                         if opt.get("add_hybrid_attention_bias") else 0)
        self.mha_flag = bool(opt.get("rnn_use_mha", False))
        share = opt.get("feats_share_weights", False)
        if self.mha_flag:
            self.att = MultiHeadAttention(
                D, opt["num_attention_heads"], opt["hidden_dropout_prob"],
                opt["layer_norm_eps"], generator,
                hybrid_length=hybrid_length,
                attention_probs_dropout_prob=opt[
                    "attention_probs_dropout_prob"],
                attend_to_video=True, dim_key=self.dim_feats,
                dim_value=self.dim_feats)
            self.dim_context = D
        elif multilevel and opt.get("with_multileval_attention", False):
            self.att = MultiLevelAttention(D, D, self.dim_feats, n_lists,
                                           generator,
                                           feats_share_weights=share)
            self.dim_context = self.dim_feats
        else:
            self.att = AdditiveAttention(
                D, D, self.dim_feats, generator, n_feats=n_lists,
                feats_share_weights=share, hybrid_length=hybrid_length)
            self.dim_context = self.dim_feats * n_lists
        self.semantic_att = (AdditiveAttention(D, D, D, generator)
                             if self.semantic_local_flag else None)
        self.dropout = Dropout(opt["hidden_dropout_prob"])
        self.with_category = bool(opt.get("with_category", False))
        self.dim_category = (opt.get("num_category", 20)
                             if self.with_category else 0)
        # the generator scheduled sampling draws from (None: torch's default
        # generator of the device); ``set_sampling_generator`` sets it
        self.sampling_generator = None

    def _get_h(self, state):
        return state[0] if self.rnn_type == "lstm" else state

    def _embed_word(self, it, semantic_hidden_states):
        word = F.embedding(it, self.word_embeddings)
        if self.semantic_global_flag:
            word = word + semantic_hidden_states
        return self.LayerNorm(word)

    def _attend(self, query, encoder_hidden_states):
        if self.mha_flag:
            context, probs, _ = self.att(query[:, None, :],
                                         encoder_hidden_states=
                                         encoder_hidden_states)
            return context[:, 0, :], probs
        return self.att(query, encoder_hidden_states)

    def forward(self, input_ids, encoder_hidden_states, cls_head=None,
                schedule_sampling_prob: float = 0.0, **kwargs):
        return _rnn_time_loop(self, input_ids, encoder_hidden_states,
                              cls_head, schedule_sampling_prob, **kwargs)


class SingleLayerRNNDecoder(_RNNDecoderBase):
    """SA-LSTM (reference ``RNN_single_layer.py``): one cell whose input is
    [word, (category), context, (concept context)], the context attended
    with h(t-1) as the query. The state starts from ``v2h`` / ``v2c`` of the
    mean features, or, with ``has_v2h_v2c`` False (VOE), from the raw mean
    features."""

    def __init__(self, opt: dict, generator: torch.Generator,
                 has_v2h_v2c: bool = True):
        super().__init__(opt, generator, multilevel=True)
        D = opt["dim_hidden"]
        dim_in = (D + self.dim_category + self.dim_context
                  + (D if self.semantic_local_flag else 0))
        self.rnn = self.cell_cls(dim_in, D, generator)
        self.has_v2h_v2c = has_v2h_v2c
        if has_v2h_v2c:
            self.v2h = dense(self.dim_feats, D, generator)
            if self.rnn_type == "lstm":
                self.v2c = dense(self.dim_feats, D, generator)

    def init_rnn_state(self, encoder_hidden_states):
        mean_v = _mean_video_features(encoder_hidden_states)
        if self.has_v2h_v2c:
            hidden = self.v2h(mean_v)
            cell = self.v2c(mean_v) if self.rnn_type == "lstm" else None
        else:
            # reference RNN_single_layer.py:91-113: without v2h / v2c (VOE)
            # h0 and c0 are the raw mean features, not zeros
            hidden = cell = mean_v
        return (hidden, cell) if self.rnn_type == "lstm" else hidden

    def forward_step(self, it, encoder_hidden_states, rnn_state=None,
                     category=None, semantic_embs=None,
                     semantic_hidden_states=None, **unused):
        """One step on the tokens ``it`` [B]: the attention outputs, the
        dropped-out hidden state [B, D] and the new cell state."""
        if rnn_state is None:
            rnn_state = self.init_rnn_state(encoder_hidden_states)
        h_query = self._get_h(rnn_state)
        context, attention_probs = self._attend(h_query,
                                                encoder_hidden_states)
        rnn_inputs = [self._embed_word(it, semantic_hidden_states)]
        if self.with_category:
            rnn_inputs.append(category)
        rnn_inputs.append(context)
        outputs = {"context": context, "attention_probs": attention_probs}
        if self.semantic_local_flag:
            sem_ctx, sem_probs = self.semantic_att(h_query, semantic_embs)
            rnn_inputs.append(sem_ctx)
            outputs["semantic_attention_probs"] = sem_probs
        x = self.dropout(torch.cat(rnn_inputs, dim=-1))
        rnn_state = self.rnn(rnn_state, x)
        outputs["hidden_states"] = self.dropout(self._get_h(rnn_state))
        outputs["decoder_rnn_hidden_states"] = rnn_state
        return outputs


def VOERNNDecoder(opt: dict, generator: torch.Generator):
    """``SingleLayerRNNDecoder`` without ``v2h`` / ``v2c`` (reference
    ``RNN_single_layer.py:354-356``)."""
    return SingleLayerRNNDecoder(opt, generator, has_v2h_v2c=False)


class TopDownAttentionRNNDecoder(_RNNDecoderBase):
    """The two-cell bottom-up / top-down decoder (reference
    ``RNN_multi_layers.py:60-184``): the bottom cell takes [word, h_top,
    mean features, (category)] and starts from tanh(``v2h``) and
    tanh(``v2c``) of the mean features; the attention queries h_bottom; the
    top cell takes [h_bottom, context, (concept context)] and starts from
    zeros."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__(opt, generator, multilevel=False)
        D = opt["dim_hidden"]
        self.bottom_rnn = self.cell_cls(
            2 * D + self.dim_feats + self.dim_category, D, generator)
        self.top_rnn = self.cell_cls(
            D + self.dim_context + (D if self.semantic_local_flag else 0), D,
            generator)
        self.v2h = dense(self.dim_feats, D, generator)
        if self.rnn_type == "lstm":
            self.v2c = dense(self.dim_feats, D, generator)

    def init_rnn_state(self, encoder_hidden_states):
        mean_v = _mean_video_features(encoder_hidden_states)
        hidden = torch.tanh(self.v2h(mean_v))
        if self.rnn_type == "lstm":
            cell = torch.tanh(self.v2c(mean_v))
            return [(hidden, cell),
                    (torch.zeros_like(hidden), torch.zeros_like(cell))]
        return [hidden, torch.zeros_like(hidden)]

    def forward_step(self, it, encoder_hidden_states, rnn_state=None,
                     category=None, semantic_embs=None,
                     semantic_hidden_states=None, **unused):
        if rnn_state is None:
            rnn_state = self.init_rnn_state(encoder_hidden_states)
        bottom_state, top_state = rnn_state
        bottom_inputs = [self._embed_word(it, semantic_hidden_states),
                         self._get_h(top_state),
                         _mean_video_features(encoder_hidden_states)]
        if self.with_category:
            bottom_inputs.append(category)
        bottom_state = self.bottom_rnn(
            bottom_state, self.dropout(torch.cat(bottom_inputs, dim=-1)))
        h_bottom = self._get_h(bottom_state)
        context, attention_probs = self._attend(h_bottom,
                                                encoder_hidden_states)
        top_inputs = [h_bottom, context]
        outputs = {"context": context, "attention_probs": attention_probs}
        if self.semantic_local_flag:
            sem_ctx, sem_probs = self.semantic_att(h_bottom, semantic_embs)
            top_inputs.append(sem_ctx)
            outputs["semantic_attention_probs"] = sem_probs
        top_state = self.top_rnn(top_state,
                                 self.dropout(torch.cat(top_inputs, dim=-1)))
        outputs["hidden_states"] = self.dropout(self._get_h(top_state))
        outputs["decoder_rnn_hidden_states"] = [bottom_state, top_state]
        return outputs


def _rnn_time_loop(decoder, input_ids, encoder_hidden_states, cls_head,
                   schedule_sampling_prob, **kwargs):
    """The RNN decoders' training forward (reference
    ``RNN_single_layer.py:179-222``; the JAX package's ``nn.scan``): one
    step per position of ``input_ids`` [B, T].

    Teacher forcing computes the logits after the loop as one [B, T, V]
    projection. Scheduled sampling (training mode, ``cls_head`` given,
    ``scheduled_sampling_start`` >= 0 and a probability above 0) feeds
    each step after the first the teacher's token when a coin U[0, 1)
    drawn from the decoder's ``sampling_generator`` is at least the
    probability, else a token sampled from the softmax of the previous
    step's logits; its outputs add ``scheduled_sampling_mask`` [B, T] (the
    positions fed a sample) and ``fed_input_ids`` [B, T].

    Returns ``hidden_states`` [B, T, D], ``attention_probs`` (each step's
    stacked on axis 2), ``logits`` and ``sentence_embs`` (the word table at
    ``input_ids``).
    """
    opt = decoder.opt
    bsz, seq_len = input_ids.shape
    use_ss = (decoder.training and cls_head is not None
              and opt.get("scheduled_sampling_start", -1) >= 0
              and schedule_sampling_prob > 0)
    state = decoder.init_rnn_state(encoder_hidden_states)
    hidden, probs, logits = [], [], []
    fed, sampled = [], []
    for t in range(seq_len):
        it = input_ids[:, t]
        if use_ss:
            if t:
                g = decoder.sampling_generator
                coin = torch.rand((bsz,), generator=g, device=it.device)
                draw = torch.multinomial(torch.softmax(logits[-1].float(),
                                                       dim=-1), 1,
                                         generator=g)[:, 0]
                take = coin < schedule_sampling_prob
                it = torch.where(take, draw, it)
            else:
                take = torch.zeros((bsz,), dtype=torch.bool,
                                   device=it.device)
            fed.append(it)
            sampled.append(take)
        out = decoder.forward_step(it, encoder_hidden_states, state,
                                   **kwargs)
        state = out["decoder_rnn_hidden_states"]
        hidden.append(out["hidden_states"])
        probs.append(out["attention_probs"])
        if use_ss:
            logits.append(cls_head(out["hidden_states"]))
    hidden = torch.stack(hidden, dim=1)
    outputs = {
        "hidden_states": hidden,
        "attention_probs": torch.stack(probs, dim=2),
        "logits": (torch.stack(logits, dim=1) if use_ss
                   else cls_head(hidden) if cls_head is not None else None),
        "sentence_embs": F.embedding(input_ids, decoder.word_embeddings),
    }
    if use_ss:
        outputs["scheduled_sampling_mask"] = torch.stack(sampled, dim=1)
        outputs["fed_input_ids"] = torch.stack(fed, dim=1)
    return outputs


def set_sampling_generator(model: nn.Module, generator) -> None:
    """Every RNN decoder of ``model`` draws its scheduled-sampling coins and
    samples from ``generator`` (a ``torch.Generator`` on the model's
    device, or None) from now on."""
    for module in model.modules():
        if isinstance(module, _RNNDecoderBase):
            module.sampling_generator = generator


def is_rnn_decoder(opt: dict) -> bool:
    return "rnn" in opt["decoder"].lower()


DECODERS = {"TransformerDecoder": TransformerDecoder,
            "TwoStageTransformerDecoder": TwoStageTransformerDecoder,
            "SingleLayerRNNDecoder": SingleLayerRNNDecoder,
            "VOERNNDecoder": VOERNNDecoder,
            "TopDownAttentionRNNDecoder": TopDownAttentionRNNDecoder}


def get_decoder(opt: dict, generator: torch.Generator) -> nn.Module:
    if opt["decoder"] not in DECODERS:
        raise ValueError(f"unknown decoder `{opt['decoder']}`")
    return DECODERS[opt["decoder"]](opt, generator)
