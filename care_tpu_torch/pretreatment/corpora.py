"""Corpus building: vocabulary (attribute-first), POS tags, length info,
splits -> ``info_corpus.pkl``; raw references -> ``refs.pkl``.

Port of ``care_tpu/pretreatment/corpora.py``, whose reference is
``misc/utils_corpora.py``: ``build_vocab`` (count threshold, frequency
sort, top-N non-stop-words placed at vocab ids [6, 6+N) = the
"attribute-first" layout, ``:207-276``), ``get_captions_and_pos_tags``
(NLTK POS tags coarse-mapped, dynamic tag vocabulary from id 6,
``:294-344``) and ``get_length_info`` (``:279-291``).

NLTK tagging is gated as in ``care_tpu``: if NLTK or its tagger data is
unavailable locally, a heuristic suffix-based tagger keeps the pipeline
runnable, so both packages choose alike in one environment.
"""

import pickle
from collections import defaultdict
from typing import Dict, List, Sequence

from care_tpu_torch import constants
from care_tpu_torch.data.corpus import get_stop_words_list


def build_vocab(train_vid2caps: Dict[str, List[List[str]]], count_thr: int = 2,
                sort_vocab: bool = True, attribute_first: bool = True,
                verbose: bool = False) -> List[str]:
    counts: Dict[str, int] = {}
    for caps in train_vid2caps.values():
        for cap in caps:
            for w in cap:
                counts[w] = counts.get(w, 0) + 1

    candidate = [(w, n) for w, n in counts.items() if n > count_thr]
    if sort_vocab:
        candidate = sorted(candidate, key=lambda x: -x[1])

    if sort_vocab and attribute_first:
        num_attributes = constants.ATTRIBUTE_END - constants.ATTRIBUTE_START
        stop_words = get_stop_words_list()
        vocab, skipped_stop = [], []
        i = -1
        for i, (w, n) in enumerate(candidate):
            if w in stop_words:
                skipped_stop.append(w)
            else:
                vocab.append(w)
                if len(vocab) == num_attributes:
                    break
        vocab += skipped_stop
        vocab += [w for w, _ in candidate[i + 1:]]
    else:
        vocab = [w for w, _ in candidate]

    bad = [w for w, n in counts.items() if n <= count_thr]
    assert len(vocab) == len(counts) - len(bad)
    return vocab


def get_length_info(captions: Dict[str, List[List[int]]],
                    max_length: int = 50) -> Dict[str, List[int]]:
    length_info = {}
    for vid, caps in captions.items():
        length_info[vid] = [0] * max_length
        for cap in caps:
            length = len(cap) - 2  # exclude BOS/EOS
            if length < max_length:
                length_info[vid][length] += 1
    return length_info


def _heuristic_pos_tag(tokens: Sequence[str]):
    """Fallback tagger when NLTK data is unavailable: suffix heuristics into
    the same coarse tag set."""
    out = []
    for w in tokens:
        if w in ("a", "an", "the", "this", "that"):
            out.append((w, "DT"))
        elif w.endswith("ing") or w.endswith("ed") or w in (
                "is", "are", "was", "were", "be"):
            out.append((w, "VB"))
        elif w in ("in", "on", "at", "of", "with", "to", "from", "over"):
            out.append((w, "IN"))
        elif w.endswith("ly"):
            out.append((w, "RB"))
        else:
            out.append((w, "NN"))
    return out


def _pos_tag(tokens):
    try:
        import nltk
        return nltk.pos_tag(list(tokens))
    except Exception:
        return _heuristic_pos_tag(tokens)


def get_captions_and_pos_tags(raw_caps_all: Dict[str, List[List[str]]],
                              vocab: List[str]):
    itow = {i + 6: w for i, w in enumerate(vocab)}
    for idx, word in enumerate(constants.SPECIAL_WORDS):
        itow[idx] = word
    wtoi = {w: i for i, w in itow.items()}

    ptoi = {w: i for i, w in enumerate(constants.SPECIAL_WORDS)}
    tag_start_i = 6

    captions = defaultdict(list)
    pos_tags = defaultdict(list)
    for vid, caps in raw_caps_all.items():
        for cap in caps:
            tag_res = _pos_tag(cap)
            caption_id = [constants.BOS]
            tagging_id = [constants.BOS]
            for w, t in zip(cap, tag_res):
                tag = constants.POS_TAG_MAPPING.get(t[1], "X")
                if w in wtoi:
                    caption_id.append(wtoi[w])
                    if tag not in ptoi:
                        ptoi[tag] = tag_start_i
                        tag_start_i += 1
                    tagging_id.append(ptoi[tag])
                else:
                    caption_id.append(constants.UNK)
                    tagging_id.append(constants.UNK)
            caption_id.append(constants.EOS)
            tagging_id.append(constants.EOS)
            captions[vid].append(caption_id)
            pos_tags[vid].append(tagging_id)

    itop = {i: t for t, i in ptoi.items()}
    return itow, dict(captions), itop, dict(pos_tags)


def prepare_corpus(raw_caps_train: Dict[str, List[List[str]]],
                   raw_caps_all: Dict[str, List[List[str]]],
                   split: Dict[str, List[int]],
                   count_thr: int = 2, itoc=None,
                   attribute_first: bool = True) -> dict:
    """Assemble the full ``info_corpus`` dict from whitespace-tokenized raw
    captions (reference ``pretreatment/prepare_corpora.py:18-105``)."""
    vocab = build_vocab(raw_caps_train, count_thr,
                        sort_vocab=True, attribute_first=attribute_first)
    itow, captions, itop, pos_tags = get_captions_and_pos_tags(
        raw_caps_all, vocab)
    return {
        "captions": captions,
        "pos_tags": pos_tags,
        "attribute_flag": attribute_first,
        "info": {
            "itow": itow,
            "itop": itop,
            "itoc": itoc,
            "split": split,
            "length_info": get_length_info(captions),
        },
    }


def build_references(raw_caps_all: Dict[str, List[List[str]]]):
    refs = {}
    for vid, caps in raw_caps_all.items():
        refs[vid] = [{"image_id": vid, "cap_id": i,
                      "caption": " ".join(c), "tokenized": " ".join(c)}
                     for i, c in enumerate(caps)]
    return refs


def prepare_category_embeddings(glove_txt: str, dim: int):
    """GloVe embeddings for the MSRVTT category names (multi-word names
    like 'sports/actions' average their parts); reference
    ``utils_corpora.py:385-421``. Returns (n_categories, dim)."""
    import numpy as np
    from care_tpu_torch.constants import INDEX2CATEGORY

    category2index = {}
    index2num = {}
    for index, category in INDEX2CATEGORY.items():
        parts = category.split("/")
        for c in parts:
            category2index[c] = index
        index2num[index] = len(parts)

    embs = np.zeros((len(INDEX2CATEGORY), dim), dtype=np.float32)
    num_exists = 0
    with open(glove_txt, encoding="utf-8") as f:
        for line in f:
            content = line.rstrip().split(" ")
            num = len(content) - dim
            w = "-".join(content[:num])
            if w in category2index:
                num_exists += 1
                embs[category2index[w]] += np.asarray(content[num:],
                                                      np.float32)
    assert num_exists == len(category2index), \
        (num_exists, len(category2index))
    for i, n in index2num.items():
        embs[i] /= n
    return embs


def save_corpus(path: str, corpus: dict):
    with open(path, "wb") as f:
        pickle.dump(corpus, f)
