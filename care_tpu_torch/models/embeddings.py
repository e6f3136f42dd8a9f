"""Embedding modules: word + position (+ GSG semantic) stacks.

Port of ``care_tpu/models/embeddings.py`` (reference
``models/components/Embeddings.py``). Position ids are passed explicitly, so
one module serves the full-sequence forward and the one-token KV-cached
decode step.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch.models.common import (Dropout, LayerNorm, dense,
                                          unsupported, xavier_param)
from care_tpu_torch.ops.attention import relative_position_index


def sinusoid_table(max_len: int, d_model: int) -> np.ndarray:
    """Classic sin/cos positional table, [max_len, d_model]."""
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    position = np.arange(max_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * -(np.log(10000.0) / d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class PositionalEmbedding(nn.Module):
    """Position embedding: a trainable table (``embedding``) or the fixed
    sinusoid, kept as a buffer outside the parameters."""

    def __init__(self, max_len: int, dim_hidden: int, trainable: bool,
                 generator: torch.Generator):
        super().__init__()
        if trainable:
            self.embedding = xavier_param((max_len, dim_hidden), generator)
        else:
            self.register_buffer(
                "embedding", torch.from_numpy(sinusoid_table(max_len,
                                                             dim_hidden)),
                persistent=False)

    def forward(self, position_ids):
        return self.embedding[position_ids]


class RelativePositionBias(nn.Module):
    """Per-head relative position bias (reference ``Embeddings.py:191-218``):
    a table of 2 * max_relative_position + 1 rows, one column per head,
    looked up by the clipped distance between key and query.

    For video keys the bias over ``n_frames`` positions is tiled across the
    concatenated modality streams (``tile_to``, reference
    ``Attention.py:99-100``).
    """

    def __init__(self, max_relative_position: int, num_heads: int,
                 generator: torch.Generator, attend_to_video: bool = False):
        super().__init__()
        self.max_relative_position = max_relative_position
        self.attend_to_video = attend_to_video
        self.embedding = xavier_param(
            (2 * max_relative_position + 1, num_heads), generator)

    def forward(self, length_q: int, length_k: int, bidirectional: bool = True,
                tile_to: int = None):
        """[1, H, length_q, length_k], or [1, H, length_q, tile_to // length_k
        * length_k] when tiled."""
        idx = relative_position_index(
            length_q, length_k, self.max_relative_position,
            bidirectional or self.attend_to_video, self.embedding.device)
        values = self.embedding[idx].permute(2, 0, 1)[None]
        if tile_to is not None and tile_to != length_k:
            values = values.repeat(1, 1, 1, tile_to // length_k)
        return values


class NaiveEmbeddings(nn.Module):
    """Word + learned position + LN + dropout: the concept-slot embeddings
    of the SemanticContainer and the retrieved captions' own embeddings
    (reference ``Embeddings.py:30-87``); ``zero_pad_row`` zeroes the PAD
    row of the word table at init."""

    def __init__(self, n_words: int, n_positions: int, dim_hidden: int,
                 layer_norm_eps: float, hidden_dropout_prob: float,
                 generator: torch.Generator, has_dropout: bool = True,
                 zero_pad_row: bool = False):
        super().__init__()
        self.word_embeddings = xavier_param((n_words, dim_hidden), generator,
                                            zero_pad_row=zero_pad_row)
        self.position_embeddings = xavier_param((n_positions, dim_hidden),
                                                generator)
        self.LayerNorm = LayerNorm(dim_hidden, eps=layer_norm_eps)
        self.dropout = Dropout(hidden_dropout_prob if has_dropout else 0.0)

    def forward(self, input_ids):
        embs = F.embedding(input_ids, self.word_embeddings)
        embs = embs + self.position_embeddings[None, :embs.shape[1]]
        return self.dropout(self.LayerNorm(embs))


class Embeddings(nn.Module):
    """Decoder input embeddings (reference ``Embeddings.py:90-188``):
    word + position (+ category) (+ the NAR decoder's ``additional_feats``)
    (+ the GSG ``semantic_hidden_states``, added to every token in ``emb``
    mode or prepended as one prefix token in ``pp_emb`` mode) -> LN ->
    dropout. With ``RPE`` the absolute position term goes unless
    ``RPE_keep_abs_pos``; with ``transformer_pre_ln`` the LN goes (the
    layers normalise their own inputs).

    ``pretrained_embs_path`` reads the word table from a local ``.npy``
    file (projected by the bias-free ``w2h`` when its width is not
    ``dim_hidden``); ``with_category`` adds a row of the learned
    ``category_embeddings`` table [num_category, D] to every token.
    """

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        if opt.get("with_category") and opt.get("use_category_embs"):
            raise unsupported("use_category_embs", opt["use_category_embs"])
        dim = opt["dim_hidden"]
        self.w2h = None
        if opt.get("pretrained_embs_path"):
            table = np.load(opt["pretrained_embs_path"]).astype(np.float32)
            if table.shape[0] != opt["vocab_size"]:
                raise ValueError(f"pretrained embeddings {table.shape} for "
                                 f"a vocabulary of {opt['vocab_size']}")
            self.word_embeddings = nn.Parameter(torch.from_numpy(table))
            if table.shape[1] != dim:
                self.w2h = dense(table.shape[1], dim, generator, bias=False)
        else:
            self.word_embeddings = xavier_param(
                (opt["vocab_size"], dim), generator, zero_pad_row=True)
        use_attr_type = opt.get("use_attr_type", "") or ""
        self.semantic_flag = "emb" in use_attr_type
        self.prefix_flag = "pp_emb" in use_attr_type
        self.position_embeddings = None
        if not opt.get("RPE", False) or opt.get("RPE_keep_abs_pos", False):
            self.position_embeddings = PositionalEmbedding(
                opt["max_len"], dim, opt.get("trainable_pe", False),
                generator)
        self.category_embeddings = None
        if opt.get("with_category"):
            self.category_embeddings = xavier_param(
                (opt["num_category"], dim), generator)
        self.LayerNorm = None
        if not opt.get("transformer_pre_ln", False):
            self.LayerNorm = LayerNorm(dim, eps=opt["layer_norm_eps"])
        self.dropout = Dropout(opt["hidden_dropout_prob"])

    def embed_tokens(self, input_ids):
        embs = F.embedding(input_ids, self.word_embeddings)
        return embs if self.w2h is None else self.w2h(embs)

    def _category(self, category):
        return self.category_embeddings[category.reshape(-1)][:, None, :]

    def embed_pp_prefix(self, semantic_hidden_states, category=None):
        """The single GSG prefix token of ``pp_emb`` mode as the full
        forward embeds it (reference ``Embeddings.py:156-168``): no
        position term, + category, the shared LN; no dropout (decode
        time). Returns [B, 1, D]."""
        embeddings = semantic_hidden_states[:, None, :]
        if self.category_embeddings is not None:
            embeddings = embeddings + self._category(category)
        if self.LayerNorm is not None:
            embeddings = self.LayerNorm(embeddings)
        return embeddings

    def forward(self, input_ids, semantic_hidden_states=None,
                position_ids=None, category=None, additional_feats=None,
                only_word_and_position: bool = False):
        embeddings = self.embed_tokens(input_ids)
        if self.position_embeddings is not None:
            if position_ids is None:
                position_ids = torch.arange(input_ids.shape[-1],
                                            device=input_ids.device)[None, :]
            embeddings = embeddings + self.position_embeddings(position_ids)
        if not only_word_and_position:
            # the semantic terms apply only where the tensor is given: the
            # decode step embeds the words of the prefix modes without it
            # (the prefix sits in the self-attention cache already)
            if (self.semantic_flag and self.prefix_flag
                    and semantic_hidden_states is not None):
                embeddings = torch.cat([semantic_hidden_states[:, None, :],
                                        embeddings], dim=1)
            if self.category_embeddings is not None:
                embeddings = embeddings + self._category(category)
            if additional_feats is not None:
                embeddings = embeddings + additional_feats
            if (self.semantic_flag and not self.prefix_flag
                    and semantic_hidden_states is not None):
                embeddings = embeddings + semantic_hidden_states[:, None, :]
        if self.LayerNorm is not None:
            embeddings = self.LayerNorm(embeddings)
        return self.dropout(embeddings)
