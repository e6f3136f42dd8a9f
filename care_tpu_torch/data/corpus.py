"""Corpus artifacts: loading ``info_corpus.pkl`` / ``refs.pkl`` and building
synthetic corpora+features for tests and benchmarks.

Port of ``care_tpu/data/corpus.py``: the same files, the same draws.

The on-disk contracts are the reference's (``README_DATA.md``,
``misc/utils_corpora.py``): ``info_corpus.pkl`` = {'captions', 'pos_tags',
'info': {'itow', 'itoc', 'itop', 'split', 'length_info', ...},
'attribute_flag'}; captions are id-lists wrapped in BOS/EOS; the top
frequent non-stop-words occupy vocab ids [6, 6+K) ("attribute-first"
sorting). ``refs.pkl`` = dict[vid] -> list of {'image_id', 'caption',
'tokenized'}.
"""

import json
import os
import pickle
from typing import Dict, List

import numpy as np

from care_tpu_torch import constants

# a small built-in stop-word list (reference ships data/en.json; any word
# list works as long as corpus building and masking agree)
STOP_WORDS = {
    "a", "an", "the", "is", "are", "was", "were", "be", "being", "been",
    "to", "of", "in", "on", "at", "for", "with", "and", "or", "but", "it",
    "its", "this", "that", "there", "their", "his", "her", "he", "she",
    "they", "them", "then", "than", "so", "as", "by", "from", "about",
    "into", "over", "under", "up", "down", "out", "off", "some", "other",
    "own", "same", "while", "during", "before", "after", "above", "below",
    "between", "both", "each", "few", "more", "most", "no", "not", "only",
    "very", "can", "will", "just", "do", "does", "did", "doing", "have",
    "has", "had", "having", "i", "you", "we", "what", "which", "who",
    "whom", "how", "when", "where", "why", "all", "any",
}


def get_stop_words_list(path: str = None):
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return json.load(f)
    return STOP_WORDS


def load_info_corpus(path: str) -> dict:
    with open(path, "rb") as f:
        return pickle.load(f)


def load_references(path: str) -> Dict[str, List[dict]]:
    with open(path, "rb") as f:
        return pickle.load(f)


def get_ids_set(mode: str, split: dict, specific: int = -1,
                split_category=None, is_vatex_activate: bool = False):
    """reference ``dataloader.py:34-52``."""
    split = dict(split)
    if is_vatex_activate:
        for m in ["train", "validate", "test"]:
            split[m] = split["activate_%s" % m]
    if mode == "all" and mode not in split:
        split["all"] = split["train"] + split["validate"] + split["test"]
    if mode == "trainval" and mode not in split:
        split["trainval"] = split["train"] + split["validate"]
    if specific != -1:
        return [int(i) for i in split_category[mode][specific]]
    return [int(i) for i in split[mode]]


# ---------------------------------------------------------------------------
# synthetic corpus + features (tests / benchmarks / demos)
# ---------------------------------------------------------------------------

_SYN_NOUNS = ["man", "woman", "dog", "cat", "car", "ball", "guitar", "song",
              "game", "road", "food", "kitchen", "child", "player", "horse"]
_SYN_VERBS = ["running", "singing", "playing", "cooking", "driving",
              "jumping", "dancing", "talking", "walking", "riding"]


def build_synthetic_corpus(n_videos: int = 40, n_caps_per_video: int = 3,
                           seed: int = 0, max_len: int = 30,
                           attribute_k: int = 500,
                           consistent: bool = False) -> dict:
    """Build an ``info_corpus``-shaped dict with a consistent vocabulary.

    The vocab respects the attribute-first layout: special tokens 0-5, then
    content words (nouns/verbs = concepts) from id 6, then stop words.

    ``consistent=True``: all of a video's captions share one
    (noun, verb, noun) triple, so features map unambiguously to caption
    content — needed by rehearsals of weaker-supervision recipes (NAR MLM)
    that cannot resolve 3 unrelated captions per video on a tiny corpus.
    """
    rng = np.random.RandomState(seed)
    content_words = _SYN_NOUNS + _SYN_VERBS
    stops = ["a", "the", "is", "on", "in", "with"]

    itow = {i: w for i, w in enumerate(constants.SPECIAL_WORDS)}
    for i, w in enumerate(content_words):
        itow[6 + i] = w
    base = 6 + len(content_words)
    for i, w in enumerate(stops):
        itow[base + i] = w
    wtoi = {w: i for i, w in itow.items()}

    # POS tag vocabulary
    itop = {0: "DET", 1: "NOUN", 2: "VERB", 3: "ADP"}

    captions = {}
    pos_tags = {}
    length_info = {}
    for v in range(n_videos):
        vid = "video%d" % v
        caps, tags = [], []
        counts = [0] * max_len
        fixed = (_SYN_NOUNS[rng.randint(len(_SYN_NOUNS))],
                 _SYN_VERBS[rng.randint(len(_SYN_VERBS))],
                 _SYN_NOUNS[rng.randint(len(_SYN_NOUNS))]) if consistent \
            else None
        for _ in range(n_caps_per_video):
            noun1, verb, noun2 = fixed if consistent else (
                _SYN_NOUNS[rng.randint(len(_SYN_NOUNS))],
                _SYN_VERBS[rng.randint(len(_SYN_VERBS))],
                _SYN_NOUNS[rng.randint(len(_SYN_NOUNS))])
            words = ["a", noun1, "is", verb, "on", "the", noun2]
            tagseq = ["DET", "NOUN", "VERB", "VERB", "ADP", "DET", "NOUN"]
            ids = ([constants.BOS] + [wtoi[w] for w in words]
                   + [constants.EOS])
            ptoi = {p: i for i, p in itop.items()}
            tag_ids = [ptoi["DET"]] + [ptoi[t] for t in tagseq] + [ptoi["DET"]]
            caps.append(ids)
            tags.append(tag_ids)
            L = len(words)              # reference: len(cap) - 2 (no BOS/EOS)
            if L < max_len:
                counts[L] += 1
        captions[vid] = caps
        pos_tags[vid] = tags
        length_info[vid] = counts

    n_train = int(n_videos * 0.6)
    n_val = int(n_videos * 0.2)
    split = {
        "train": list(range(0, n_train)),
        "validate": list(range(n_train, n_train + n_val)),
        "test": list(range(n_train + n_val, n_videos)),
    }

    return {
        "captions": captions,
        "pos_tags": pos_tags,
        "attribute_flag": True,
        "info": {
            "itow": itow,
            "itop": itop,
            "itoc": {v: v % 20 for v in range(n_videos)},
            "split": split,
            "length_info": length_info,
        },
    }


def build_synthetic_references(corpus: dict) -> Dict[str, List[dict]]:
    itow = corpus["info"]["itow"]
    refs = {}
    for vid, caps in corpus["captions"].items():
        refs[vid] = []
        for i, cap in enumerate(caps):
            sent = " ".join(itow[w] for w in cap[1:-1])
            refs[vid].append({"image_id": vid, "cap_id": i,
                              "caption": sent, "tokenized": sent})
    return refs


def write_synthetic_dataset(root: str, opt: dict, n_videos: int = 40,
                            seed: int = 0, correlated: bool = False,
                            consistent: bool = False):
    """Materialise a synthetic dataset with the reference's on-disk layout:
    ``<root>/<dataset>/info_corpus.pkl``, ``refs.pkl`` and per-modality
    HDF5 feature files under ``feats/``.

    ``correlated=True`` makes features a (noisy) linear function of the
    video's caption content words, so captions are learnable from features
    — used by the end-to-end learning tests.

    The ``t`` stream (PointerGen's retrieved captions) is a retrieval
    database ``synthetic_t.hdf5``: per video a row ``video<k>_i`` of
    ``max(retrieval_topk, 20)`` indices into the training split's captions
    in flat order, as ``datasets.JointDataset.load_t_feats`` reads it.
    """
    import h5py

    dataset_dir = os.path.join(root, opt["dataset"])
    feats_dir = os.path.join(dataset_dir, "feats")
    os.makedirs(feats_dir, exist_ok=True)

    corpus = build_synthetic_corpus(
        n_videos=n_videos, seed=seed, max_len=opt["max_len"],
        attribute_k=opt.get("attribute_prediction_k", 500),
        consistent=consistent)
    refs = build_synthetic_references(corpus)

    with open(os.path.join(dataset_dir, "info_corpus.pkl"), "wb") as f:
        pickle.dump(corpus, f)
    with open(os.path.join(dataset_dir, "refs.pkl"), "wb") as f:
        pickle.dump(refs, f)

    vocab_size = len(corpus["info"]["itow"])
    rng = np.random.RandomState(seed + 1)
    n_total = opt.get("n_total_frames", constants.N_TOTAL_FRAMES)
    paths = {}
    for char in opt["modality"]:
        if char == "t":
            paths[char] = _write_retrieval_db(
                os.path.join(feats_dir, "synthetic_t.hdf5"), corpus, opt,
                n_videos, rng)
            continue
        dim = opt[f"dim_{char}"]
        word_codes = rng.randn(vocab_size, dim).astype(np.float32)
        p = os.path.join(feats_dir, f"synthetic_{char}.hdf5")
        with h5py.File(p, "w") as hf:
            for v in range(n_videos):
                if correlated:
                    wids = sorted({w for cap in corpus["captions"]
                                   ["video%d" % v] for w in cap[1:-1]})
                    base = word_codes[wids].sum(axis=0, keepdims=True)
                    data = (base + 0.1 * rng.randn(n_total, dim)
                            ).astype(np.float32)
                else:
                    data = rng.randn(n_total, dim).astype(np.float32)
                hf.create_dataset("video%d" % v, data=data)
        paths[char] = p
    return dataset_dir, paths, corpus, refs


def _write_retrieval_db(path: str, corpus: dict, opt: dict, n_videos: int,
                        rng: np.random.RandomState) -> str:
    """A retrieval database of random training-caption indices per video."""
    import h5py

    train_ids = get_ids_set("train", corpus["info"]["split"])
    n_flat = sum(len(corpus["captions"]["video%d" % v]) for v in train_ids)
    topk = max(opt.get("retrieval_topk", 20), 20)
    with h5py.File(path, "w") as hf:
        for v in range(n_videos):
            hf.create_dataset("video%d_i" % v,
                              data=rng.randint(0, n_flat, topk))
    return path
