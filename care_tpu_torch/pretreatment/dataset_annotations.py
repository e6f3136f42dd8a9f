"""Per-dataset raw-annotation parsers -> (raw captions, splits, categories).

Port of ``care_tpu/pretreatment/dataset_annotations.py``, whose reference
is ``misc/utils_corpora.py:13-195`` (``preprocess_MSVD/MSRVTT/VATEX``),
minus the wget downloads: the annotation files must already exist
locally; the parsing, splitting and tokenisation are the same.

Each function returns a dict with 'split', 'raw_caps_train',
'raw_caps_all', plus dataset extras ('vid2id', 'itoc', 'split_category',
'references'), ready for ``pretreatment.corpora.prepare_corpus``.
"""

import json
import os
import pickle
import string
from collections import defaultdict
from typing import Dict


def preprocess_msvd(refs_pickle: str, mapping_txt: str) -> Dict:
    """MSVD: refs.pkl (dict[vid] -> [{'caption': ...}]) + youtube-id mapping
    (reference ``utils_corpora.py:13-54``)."""
    with open(mapping_txt) as f:
        mapping_info = f.read().strip().split("\n")
    vid2id = {}
    for line in mapping_info:
        _id, vid = line.split()
        vid2id[vid] = _id

    split = {"train": list(range(1200)),
             "validate": list(range(1200, 1300)),
             "test": list(range(1300, 1970))}

    with open(refs_pickle, "rb") as f:
        refs = pickle.load(f)

    raw_caps_all = defaultdict(list)
    raw_caps_train = {}
    for vid in refs:
        num = int(vid[5:])
        for item in refs[vid]:
            raw_caps_all[vid].append(item["caption"].lower().split())
        if num in set(split["train"]):
            raw_caps_train[vid] = raw_caps_all[vid]

    return {"split": split, "raw_caps_train": raw_caps_train,
            "raw_caps_all": dict(raw_caps_all), "vid2id": vid2id}


def preprocess_msrvtt(videodatainfo_json: str) -> Dict:
    """MSRVTT: the official videodatainfo json (videos + sentences)
    (reference ``utils_corpora.py:57-109``)."""
    with open(videodatainfo_json) as f:
        json_data = json.load(f)
    sentences = json_data["sentences"]
    videos = json_data["videos"]

    split = {"train": [], "validate": [], "test": []}
    for v in videos:
        split[v["split"]].append(int(v["id"]))
    train_set = set(split["train"])

    raw_caps_all = defaultdict(list)
    raw_caps_train = defaultdict(list)
    references = defaultdict(list)
    for item in sentences:
        vid = item["video_id"]
        tokens = [tok.lower() for tok in item["caption"].split()
                  if tok not in string.punctuation]
        raw_caps_all[vid].append(tokens)
        if int(vid[5:]) in train_set:
            raw_caps_train[vid].append(tokens)
        references[vid].append({"image_id": vid,
                                "cap_id": len(references[vid]),
                                "caption": " ".join(tokens)})

    itoc = {}
    split_category = {"train": defaultdict(list),
                      "validate": defaultdict(list),
                      "test": defaultdict(list)}
    for item in videos:
        itoc[item["id"]] = item["category"]
        split_category[item["split"]][int(item["category"])].append(
            int(item["id"]))

    return {"split": split, "raw_caps_train": dict(raw_caps_train),
            "raw_caps_all": dict(raw_caps_all),
            "references": dict(references), "itoc": itoc,
            "split_category": {k: dict(v) for k, v in
                               split_category.items()}}


def preprocess_vatex(train_json: str, val_json: str,
                     mapping_txt: str = None,
                     frames_root: str = None) -> Dict:
    """VATEX: official annotation jsons (lists of
    {'videoID', 'enCap': [...]}); train json -> train split, val json split
    into validate/test halves like the reference (``utils_corpora.py:112-195``).
    ``frames_root`` (if given) derives the 'activate_*' splits: videos whose
    frames are actually present on disk."""
    with open(mapping_txt) as f:
        mapping_info = f.read().strip().split("\n") if mapping_txt else []
    vid2id = {}
    for line in mapping_info:
        _id, vid = line.split()
        vid2id[vid] = _id

    def load(path):
        with open(path) as f:
            return json.load(f)

    train_data = load(train_json)
    val_data = load(val_json)

    split = {"train": [], "validate": [], "test": []}
    raw_caps_all = {}
    raw_caps_train = {}
    id2vid = {}
    index = 0

    def tokenize(cap):
        try:
            import nltk
            return [t.lower() for t in nltk.word_tokenize(cap)]
        except Exception:
            return cap.lower().split()

    for item in train_data:
        vid = "video%d" % index
        id2vid[item["videoID"]] = vid
        split["train"].append(index)
        caps = [tokenize(c) for c in item["enCap"]]
        raw_caps_all[vid] = caps
        raw_caps_train[vid] = caps
        index += 1

    half = len(val_data) // 2
    for i, item in enumerate(val_data):
        vid = "video%d" % index
        id2vid[item["videoID"]] = vid
        split["validate" if i < half else "test"].append(index)
        raw_caps_all[vid] = [tokenize(c) for c in item["enCap"]]
        index += 1

    out = {"split": split, "raw_caps_train": raw_caps_train,
           "raw_caps_all": raw_caps_all,
           "vid2id": {v: k for k, v in id2vid.items()}}

    if frames_root and os.path.isdir(frames_root):
        present = set(os.listdir(frames_root))
        for mode in ["train", "validate", "test"]:
            out["split"]["activate_%s" % mode] = [
                i for i in split[mode] if "video%d" % i in present]
    return out
