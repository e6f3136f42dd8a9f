"""CLIP byte-pair-encoding tokenizer (caption encoding for the CLIP text
tower, and the reference's optional CLIP-tokenizer data path,
``dataloader.py:367-371``).

Port of ``care_tpu/pretreatment/bpe.py``: the CLIP BPE algorithm over the
``bpe_simple_vocab_16e6.txt.gz`` merges file, whose local path the caller
gives ``ClipTokenizer`` (nothing is downloaded).
"""

import gzip
import html
import os
import re
from functools import lru_cache
from typing import List


@lru_cache()
def bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(2 ** 8):
        if b not in bs:
            bs.append(b)
            cs.append(2 ** 8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def basic_clean(text):
    return html.unescape(html.unescape(text)).strip()


def whitespace_clean(text):
    return re.sub(r"\s+", " ", text).strip()


class ClipTokenizer:
    def __init__(self, bpe_path: str):
        assert os.path.exists(bpe_path), bpe_path
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = merges[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges]
        vocab = list(bytes_to_unicode().values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = dict(zip(vocab, range(len(vocab))))
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}
        # CLIP's pattern with ASCII classes for \p{L} / \p{N} (the standard
        # ``re`` has no Unicode property classes), as ``care_tpu`` has it
        self.pat = re.compile(
            r"""<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"""
            r"""|[a-zA-Z]+|[0-9]|[^\sa-zA-Z0-9]+""", re.IGNORECASE)

    def bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, 1e10))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                    new_word.extend(word[i:j])
                    i = j
                except ValueError:
                    new_word.extend(word[i:])
                    break
                if (word[i] == first and i < len(word) - 1
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        bpe_tokens = []
        text = whitespace_clean(basic_clean(text)).lower()
        for token in re.findall(self.pat, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            bpe_tokens.extend(self.encoder[t]
                              for t in self.bpe(token).split(" "))
        return bpe_tokens

    def tokenize(self, texts, context_length: int = 77,
                 truncate: bool = False):
        """texts -> int32 [n, context_length] with SOT/EOT wrapping
        (reference ``misc/utils.py:422``-style)."""
        import numpy as np
        if isinstance(texts, str):
            texts = [texts]
        sot = self.encoder["<|startoftext|>"]
        eot = self.encoder["<|endoftext|>"]
        out = np.zeros((len(texts), context_length), np.int32)
        for i, text in enumerate(texts):
            ids = [sot] + self.encode(text) + [eot]
            if len(ids) > context_length:
                if truncate:
                    ids = ids[:context_length]
                    ids[-1] = eot
                else:
                    raise RuntimeError(f"too long: {text}")
            out[i, :len(ids)] = ids
        return out
