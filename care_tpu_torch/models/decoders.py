"""The Transformer decoder: full forward and KV-cached incremental decode.

Port of ``care_tpu/models/decoders.py:TransformerDecoder`` (reference
``models/Decoder/Transformer.py``) for AR decoding without concepts or in
the flagship's G-LSG modes (GSG ``emb`` per-token add, LSG ``concat`` keys),
post- or pre-LN, with or without relative-position biases. Masks are
additive 0/-1e9 biases computed from the token ids.
"""

from typing import Any, Dict

import torch
from torch import nn

from care_tpu_torch import constants
from care_tpu_torch.models.common import Dropout, LayerNorm, unsupported
from care_tpu_torch.models.embeddings import Embeddings
from care_tpu_torch.models.layers import DecoderLayer
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
        if opt["decoder"] != "TransformerDecoder":
            raise unsupported("decoder", opt["decoder"])
        if opt["decoding_type"] != "ARFormer":
            raise unsupported("decoding_type", opt["decoding_type"])
        if opt.get("TAP_pos") or opt.get("TAP_ln"):
            raise unsupported("TAP_pos/TAP_ln")
        self.opt = opt
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

    @property
    def layers(self):
        return [getattr(self, f"layer_{i}") for i in range(self.num_layers)]

    def forward(self, input_ids, encoder_hidden_states,
                semantic_hidden_states=None) -> Dict[str, Any]:
        """Full forward over ``input_ids`` [B, L]. Returns
        {"hidden_states": [B, L, D]}."""
        attention_bias = (key_pad_bias(input_ids, input_ids.shape[1])
                          + causal_bias(input_ids.shape[1],
                                        self.opt.get("watch", 0),
                                        input_ids.device))
        hidden_states = self.embedding(
            input_ids, semantic_hidden_states=semantic_hidden_states)
        # every encoder position is visible (the reference builds an
        # all-ones source mask), so the cross attention needs no mask
        for layer in self.layers:
            hidden_states, _ = layer(
                hidden_states, encoder_hidden_states,
                attention_mask=attention_bias,
                decoding_type=self.opt["decoding_type"],
                n_frames=self.opt["n_frames"])
        if self.LayerNorm is not None:
            hidden_states = self.LayerNorm(hidden_states)
        return {"hidden_states": self.dropout(hidden_states)}

    # ----- KV-cached incremental decoding ------------------------------------
    def init_decode_state(self, batch_size: int, max_len: int,
                          encoder_hidden_states, semantic_hidden_states=None,
                          beam_size: int = 1) -> Dict[str, Any]:
        """The decode cache: cross-attention K/V per layer + an empty
        self-attention K/V cache.

        With ``beam_size`` > 1 the encoder-side inputs arrive un-enlarged
        ([B, ...]); only the per-row state (the self K/V cache and the GSG
        vector the step embedding adds) is laid out at ``batch_size``
        (= B*beam) rows, instance-major. Cross-attention K/V stay at [B]:
        ``attend`` folds the beam into the query rows.
        """
        h = self.opt["num_attention_heads"]
        dh = self.opt["dim_hidden"] // h
        layers_state = []
        for layer in self.layers:
            shape = (batch_size, h, max_len, dh)
            layers_state.append({
                "inter_kv": layer.init_step(encoder_hidden_states),
                "self_k": encoder_hidden_states.new_zeros(shape),
                "self_v": encoder_hidden_states.new_zeros(shape)})
        if semantic_hidden_states is not None and beam_size > 1:
            semantic_hidden_states = semantic_hidden_states.repeat_interleave(
                beam_size, dim=0)
        return {"layers": layers_state,
                "semantic_hidden_states": semantic_hidden_states}

    def decode_step(self, token_ids, position: int, state):
        """One AR step. token_ids: [B] int; position: the 0-based word
        position. Writes this step's self-attention K/V into the cache in
        place and returns (hidden [B, D], state)."""
        cache_len = state["layers"][0]["self_k"].shape[2]
        x = self.embedding(
            token_ids[:, None],
            semantic_hidden_states=state["semantic_hidden_states"],
            position_ids=torch.full((token_ids.shape[0], 1), position,
                                    device=token_ids.device))
        visible = torch.arange(cache_len, device=token_ids.device) <= position
        self_bias = torch.zeros(cache_len, device=token_ids.device)
        self_bias = self_bias.masked_fill(~visible, NEG_INF)[None, None, None]
        h = x
        for layer, st in zip(self.layers, state["layers"]):
            q, (k, v) = layer.self_qkv(h)
            st["self_k"][:, :, position:position + 1] = k
            st["self_v"][:, :, position:position + 1] = v
            # the relative-position rows select by the position in the
            # full sequence
            h = layer.step(h, position, (st["self_k"], st["self_v"]),
                           st["inter_kv"], self_bias=self_bias,
                           n_frames=self.opt["n_frames"], q=q)
        if self.LayerNorm is not None:
            h = self.LayerNorm(h)
        return h[:, 0, :], state


def get_decoder(opt: dict, generator: torch.Generator) -> nn.Module:
    return TransformerDecoder(opt, generator)
