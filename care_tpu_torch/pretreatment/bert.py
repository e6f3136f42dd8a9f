"""BERT caption embeddings (and a pure-Python WordPiece tokenizer).

Port of ``care_tpu/pretreatment/bert.py`` (reference
``pretreatment/bert_text_embs.py``): every reference caption of every video
goes through ``bert-base-uncased``, and its last hidden states are pooled
over the caption's own (non-special) tokens by mean or max, one
``[n_captions, hidden]`` HDF5 dataset per video (``BERT.hdf5`` /
``BERT_max.hdf5`` under ``<dataset>/text_embs/``).

The weights convert from a local HuggingFace ``BertModel`` state dict and
the tokenizer reads a local ``vocab.txt``: nothing is downloaded. The
encoder's modules carry the flax names of ``care_tpu``'s (``layer_<i>``,
``query``, ``attn_ln``, ...): HF ``BertModel`` semantics with the erf GELU,
LayerNorm epsilon 1e-12 and an additive mask bias of ``(1 - mask) x the
dtype's most negative finite value``. Attention is plain ``matmul`` and
``softmax``, as ``care_tpu`` computes it outside any Pallas kernel.
"""

import unicodedata
from typing import Dict, List, Sequence

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F


# ---------------------------------------------------------------------------
# WordPiece tokenizer (BertTokenizer semantics: BasicTokenizer + WordPiece)
# ---------------------------------------------------------------------------

def _is_punct(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) \
            or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))


class WordPieceTokenizer:
    """``bert-base-uncased``-style tokenization from a local vocab.txt."""

    def __init__(self, vocab_file: str, lowercase: bool = True,
                 max_chars_per_word: int = 100):
        with open(vocab_file, encoding="utf-8") as f:
            self.vocab = {line.rstrip("\n"): i for i, line in enumerate(f)}
        self.inv_vocab = {i: w for w, i in self.vocab.items()}
        self.lowercase = lowercase
        self.max_chars = max_chars_per_word
        self.unk, self.cls, self.sep, self.pad = (
            self.vocab["[UNK]"], self.vocab["[CLS]"], self.vocab["[SEP]"],
            self.vocab["[PAD]"])

    def _basic_tokenize(self, text: str) -> List[str]:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or unicodedata.category(ch) == "Cc" \
                    and ch not in ("\t", "\n", "\r"):
                continue
            if _is_cjk(cp):
                out.append(f" {ch} ")
            elif ch in ("\t", "\n", "\r") or unicodedata.category(ch) == "Zs":
                out.append(" ")
            else:
                out.append(ch)
        tokens = []
        for tok in "".join(out).split():
            if self.lowercase:
                tok = tok.lower()
                tok = "".join(c for c in unicodedata.normalize("NFD", tok)
                              if unicodedata.category(c) != "Mn")
            # split punctuation into its own tokens
            word = []
            for ch in tok:
                if _is_punct(ch):
                    if word:
                        tokens.append("".join(word))
                        word = []
                    tokens.append(ch)
                else:
                    word.append(ch)
            if word:
                tokens.append("".join(word))
        return tokens

    def _wordpiece(self, word: str) -> List[int]:
        if len(word) > self.max_chars:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end, cur = len(word), None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = self.vocab[sub]
                    break
                end -= 1
            if cur is None:
                return [self.unk]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[int]:
        ids = []
        for word in self._basic_tokenize(text):
            ids.extend(self._wordpiece(word))
        return ids

    def encode_batch(self, texts: List[str], max_len: int = 512):
        """[CLS] tokens [SEP] + pad -> (input_ids, attention_mask, n_tokens);
        ``n_tokens`` excludes the special tokens (reference
        ``bert_text_embs.py:57-59`` computes ``len(input_ids) - 2``)."""
        seqs = [self.tokenize(t)[:max_len - 2] for t in texts]
        lens = np.asarray([len(s) for s in seqs], np.int32)
        width = int(lens.max()) + 2 if len(seqs) else 2
        ids = np.full((len(seqs), width), self.pad, np.int32)
        mask = np.zeros((len(seqs), width), np.int32)
        for i, s in enumerate(seqs):
            row = [self.cls] + s + [self.sep]
            ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return ids, mask, lens


# ---------------------------------------------------------------------------
# BERT encoder (HF BertModel semantics)
# ---------------------------------------------------------------------------

class BertLayer(nn.Module):
    def __init__(self, hidden: int, heads: int, intermediate: int,
                 eps: float = 1e-12):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(hidden, hidden)
        self.key = nn.Linear(hidden, hidden)
        self.value = nn.Linear(hidden, hidden)
        self.attn_out = nn.Linear(hidden, hidden)
        self.attn_ln = nn.LayerNorm(hidden, eps=eps)
        self.inter = nn.Linear(hidden, intermediate)
        self.out = nn.Linear(intermediate, hidden)
        self.out_ln = nn.LayerNorm(hidden, eps=eps)
        # the f32 square root of the head width, as care_tpu divides by it
        self.scale = float(np.sqrt(np.float32(hidden // heads)))

    def forward(self, x, mask_bias):
        b, L, h = x.shape

        def split(t):
            return t.reshape(b, L, self.heads, h // self.heads).transpose(1, 2)

        scores = torch.matmul(split(self.query(x)),
                              split(self.key(x)).transpose(-1, -2)) \
            / self.scale
        probs = torch.softmax(scores + mask_bias, dim=-1)
        ctx = torch.matmul(probs, split(self.value(x)))
        ctx = ctx.transpose(1, 2).reshape(b, L, h)
        x = self.attn_ln(x + self.attn_out(ctx))
        y = F.gelu(self.inter(x), approximate="none")
        return self.out_ln(x + self.out(y))


class BertEncoder(nn.Module):
    """input_ids [B, L] + attention_mask [B, L] -> last hidden [B, L, H].
    The weights are seeded noise until a converted state dict is loaded
    (``convert_hf_bert_state_dict``)."""

    def __init__(self, vocab_size: int = 30522, hidden: int = 768,
                 layers: int = 12, heads: int = 12, intermediate: int = 3072,
                 max_position: int = 512, type_vocab: int = 2,
                 eps: float = 1e-12, generator: torch.Generator = None):
        super().__init__()

        def table(*shape):
            return nn.Parameter(0.02 * torch.randn(*shape,
                                                   generator=generator))

        self.word_embeddings = table(vocab_size, hidden)
        self.position_embeddings = table(max_position, hidden)
        self.token_type_embeddings = table(type_vocab, hidden)
        self.emb_ln = nn.LayerNorm(hidden, eps=eps)
        self.layers = layers
        for i in range(layers):
            self.add_module(f"layer_{i}",
                            BertLayer(hidden, heads, intermediate, eps))
        with torch.no_grad():
            for name, p in self.named_parameters():
                if name.endswith(".weight") and p.dim() == 2:
                    p.normal_(0.0, 0.02, generator=generator)

    def forward(self, input_ids, attention_mask):
        L = input_ids.shape[1]
        x = (F.embedding(input_ids, self.word_embeddings)
             + self.position_embeddings[None, :L]
             + self.token_type_embeddings[0][None, None])
        x = self.emb_ln(x)
        bias = (1.0 - attention_mask[:, None, None, :].to(x.dtype)) \
            * torch.finfo(x.dtype).min
        for i in range(self.layers):
            x = getattr(self, f"layer_{i}")(x, bias)
        return x


def convert_hf_bert_state_dict(sd: Dict[str, np.ndarray]):
    """HF ``BertModel`` state_dict (arrays or tensors) -> (the state dict
    of the port's ``BertEncoder``, its config)."""
    sd = {k.removeprefix("bert."): torch.as_tensor(np.asarray(v))
          for k, v in sd.items()}
    out = {
        "word_embeddings": sd["embeddings.word_embeddings.weight"],
        "position_embeddings": sd["embeddings.position_embeddings.weight"],
        "token_type_embeddings": sd[
            "embeddings.token_type_embeddings.weight"],
        "emb_ln.weight": sd["embeddings.LayerNorm.weight"],
        "emb_ln.bias": sd["embeddings.LayerNorm.bias"],
    }
    n_layers = len({k.split(".")[2] for k in sd
                    if k.startswith("encoder.layer.")})
    for i in range(n_layers):
        pre, ours_pre = f"encoder.layer.{i}", f"layer_{i}"
        for ours, theirs in (
                ("query", "attention.self.query"),
                ("key", "attention.self.key"),
                ("value", "attention.self.value"),
                ("attn_out", "attention.output.dense"),
                ("inter", "intermediate.dense"),
                ("out", "output.dense"),
                ("attn_ln", "attention.output.LayerNorm"),
                ("out_ln", "output.LayerNorm")):
            for p in ("weight", "bias"):
                out[f"{ours_pre}.{ours}.{p}"] = sd[f"{pre}.{theirs}.{p}"]
    vocab_size, hidden = sd["embeddings.word_embeddings.weight"].shape
    config = dict(
        vocab_size=vocab_size, hidden=hidden, layers=n_layers,
        heads=max(1, hidden // 64),
        intermediate=sd["encoder.layer.0.intermediate.dense.weight"].shape[0],
        max_position=sd["embeddings.position_embeddings.weight"].shape[0],
        type_vocab=sd["embeddings.token_type_embeddings.weight"].shape[0])
    return {k: v.float().contiguous() for k, v in out.items()}, config


def load_bert(state: Dict[str, torch.Tensor], config: dict,
              device=None) -> BertEncoder:
    """A ``BertEncoder`` of ``config`` holding ``state``, in eval mode on
    ``device`` (None = the CUDA card)."""
    from care_tpu_torch.utils.device import resolve_device
    model = BertEncoder(**config)
    model.load_state_dict(state, strict=True)
    return model.eval().to(resolve_device(device))


# ---------------------------------------------------------------------------
# caption-embedding extraction
# ---------------------------------------------------------------------------

def pool_caption_embs(hidden_states, lens, mode: str = "mean"):
    """Pool last hidden states [B, L, H] over tokens 1..1+len of each
    caption (skipping [CLS], [SEP] and padding), mean or max (reference
    ``bert_text_embs.py:66-72``); a tensor in, a tensor out (numpy in,
    numpy out)."""
    as_numpy = not torch.is_tensor(hidden_states)
    h = torch.tensor(np.asarray(hidden_states)) if as_numpy \
        else hidden_states
    n = torch.as_tensor(np.asarray(lens) if as_numpy else lens,
                        device=h.device).long()
    pos = torch.arange(h.shape[1], device=h.device)
    keep = ((pos[None] >= 1) & (pos[None] < 1 + n[:, None]))[..., None]
    if mode == "mean":
        out = torch.where(keep, h, 0.0).sum(1) / n[:, None].to(h.dtype)
    else:
        out = torch.where(keep, h, float("-inf")).amax(1)
    return out.numpy() if as_numpy else out


@torch.no_grad()
def embed_captions(model: BertEncoder, tokenizer: WordPieceTokenizer,
                   captions: Sequence[str], modes=("mean",),
                   batch_size: int = 512) -> Dict[str, torch.Tensor]:
    """Pooled BERT embeddings of ``captions`` [N, H] for each pooling mode,
    on the model's device, in batches of ``batch_size`` (each padded to its
    longest caption)."""
    device = next(model.parameters()).device
    out = {m: [] for m in modes}
    for i in range(0, len(captions), batch_size):
        ids, mask, lens = tokenizer.encode_batch(
            list(captions[i:i + batch_size]))
        hidden = model(torch.as_tensor(ids, device=device).long(),
                       torch.as_tensor(mask, device=device))
        lens = torch.as_tensor(lens, device=device)
        for m in modes:
            out[m].append(pool_caption_embs(hidden, lens, m))
    return {m: torch.cat(v) if v else torch.zeros(0) for m, v in out.items()}


def extract_text_embs(model: BertEncoder, refs: Dict[str, list],
                      tokenizer: WordPieceTokenizer, out_path: str,
                      mode: str = "mean", video_ids: List[str] = None):
    """refs.pkl dict -> HDF5 with one [n_captions, hidden] dataset per
    video (a video already in the file is kept), each video's captions one
    batch."""
    import h5py
    keys = video_ids if video_ids is not None else sorted(refs.keys())
    with h5py.File(out_path, "a") as hf:
        for vid in keys:
            if vid in hf:
                continue
            captions = [e["caption"] for e in refs[vid]]
            embs = embed_captions(model, tokenizer, captions, (mode,),
                                  batch_size=len(captions))[mode]
            hf[vid] = embs.cpu().numpy().astype(np.float32)
    return out_path
