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
"""

from typing import Any, Dict

import torch
from torch import nn

from care_tpu_torch import constants
from care_tpu_torch.models.common import Dropout, LayerNorm, unsupported
from care_tpu_torch.models.embeddings import Embeddings
from care_tpu_torch.models.layers import DecoderLayer
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
                attr_input_ids=None, collect_aux: bool = True,
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
            category=category, additional_feats=additional_feats)
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
                          category=None, beam_size: int = 1
                          ) -> Dict[str, Any]:
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
        h = opt["num_attention_heads"]
        dh = opt["dim_hidden"] // h
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
            shape = (batch_size, h, cache_len, dh)
            layers_state.append({
                "inter_kv": inter_kv, "attr_kv": attr_kv,
                "self_k": encoder_hidden_states.new_zeros(shape),
                "self_v": encoder_hidden_states.new_zeros(shape)})
        state = {"layers": layers_state,
                 "aux": {"category": rep(category),
                         "semantic_hidden_states": rep(semantic_hidden_states),
                         "preds_attr": rep(preds_attr)}}
        if self.prefix_len:
            if self.concept_prefix:
                x = semantic_embs
            else:
                x = self.embedding.embed_pp_prefix(semantic_hidden_states,
                                                   category=category)
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
            category=aux["category"])
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


DECODERS = {"TransformerDecoder": TransformerDecoder,
            "TwoStageTransformerDecoder": TwoStageTransformerDecoder}


def get_decoder(opt: dict, generator: torch.Generator) -> nn.Module:
    if opt["decoder"] not in DECODERS:
        raise unsupported("decoder", opt["decoder"])
    return DECODERS[opt["decoder"]](opt, generator)
