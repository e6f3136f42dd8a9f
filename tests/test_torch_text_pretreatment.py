"""The text side of pretreatment against ``care_tpu``: the annotation parsers
(``pretreatment/dataset_annotations.py``), the corpus assembly
(``pretreatment/corpora.py``) and the CLI's ``corpora``, ``glove`` and
``text_embs --arch bert``, on synthetic annotation files.

* MSVD, MSRVTT and VATEX parsers: equal outputs;
* the vocabulary (attribute-first), the POS tags under both gates (NLTK's
  tagger where it answers, the heuristic where it raises: the choice falls
  alike), the length info, ``prepare_corpus``'s corpus equal once pickled
  and loaded, ``build_references``, the category embeddings;
* ``python -m care_tpu_torch.pretreatment_cli corpora`` (three datasets),
  ``glove`` (with the category embeddings) and ``text_embs --arch bert``
  (mean and max) write the files the root ``pretreatment_cli.py`` writes:
  pickles and arrays equal, BERT's HDF5 within the encoder's bound of
  ``tests/test_torch_bert.py`` (2e-5 absolute + 1e-4 relative).
"""

import json
import os
import pickle
import sys

import h5py
import numpy as np
import pytest
import torch

import pretreatment_cli as jax_cli
from care_tpu.pretreatment import corpora as jax_corpora
from care_tpu.pretreatment import dataset_annotations as jax_da
from care_tpu_torch import constants
from care_tpu_torch import pretreatment_cli as cli
from care_tpu_torch.pretreatment import corpora
from care_tpu_torch.pretreatment import dataset_annotations as da

WORDS = ["a", "man", "woman", "dog", "is", "running", "playing", "on",
         "the", "stage", "quickly", "with", "guitar", "cooked", "in",
         "kitchen", "an", "cat", "jumps", "over"]


def _caption(rs, n=None):
    n = n or rs.randint(3, 9)
    return " ".join(WORDS[i] for i in rs.randint(0, len(WORDS), n))


def _msrvtt(path, n_videos=12, seed=0):
    rs = np.random.RandomState(seed)
    splits = ["train"] * 6 + ["validate"] * 3 + ["test"] * 3
    videos = [{"id": i, "video_id": f"video{i}", "split": splits[i],
               "category": int(rs.randint(0, 20))} for i in range(n_videos)]
    sentences = [{"video_id": f"video{i}",
                  "caption": _caption(rs) + rs.choice(["", " .", " !"])}
                 for i in range(n_videos) for _ in range(4)]
    with open(path, "w") as f:
        json.dump({"videos": videos, "sentences": sentences}, f)
    return path


def _msvd(root, seed=1):
    rs = np.random.RandomState(seed)
    vids = [f"video{i}" for i in (0, 3, 7, 1199, 1200, 1250, 1300, 1969)]
    refs = {v: [{"caption": _caption(rs).capitalize()} for _ in range(3)]
            for v in vids}
    refs_path = os.path.join(root, "msvd_refs.pkl")
    with open(refs_path, "wb") as f:
        pickle.dump(refs, f)
    mapping = os.path.join(root, "youtube_mapping.txt")
    with open(mapping, "w") as f:
        f.write("\n".join(f"yt{i}_{v} {v}" for i, v in enumerate(vids)))
    return refs_path, mapping


def _vatex(root, seed=2):
    rs = np.random.RandomState(seed)

    def items(prefix, n):
        return [{"videoID": f"{prefix}{i}",
                 "enCap": [_caption(rs) + ", " + _caption(rs, 3) + "."
                           for _ in range(3)]} for i in range(n)]

    paths = []
    for name, data in (("train", items("tr", 5)), ("val", items("va", 4))):
        paths.append(os.path.join(root, f"vatex_{name}.json"))
        with open(paths[-1], "w") as f:
            json.dump(data, f)
    mapping = os.path.join(root, "vatex_mapping.txt")
    with open(mapping, "w") as f:
        f.write("\n".join(f"{i} tr{i}" for i in range(5)))
    frames = os.path.join(root, "vatex_frames")
    for v in ("video0", "video2", "video6", "video8"):
        os.makedirs(os.path.join(frames, v), exist_ok=True)
    return paths[0], paths[1], mapping, frames


def _run_jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pretreatment_cli.py"] + argv)
    jax_cli.main()


def _load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def _assert_tree_equal(got, want):
    """Pickled trees: dicts and lists equal, numpy leaves equal."""
    assert type(got) is type(want), (type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_tree_equal(got[k], want[k])
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


@pytest.mark.parametrize("dataset", ["MSVD", "MSRVTT", "VATEX"])
def test_annotation_parsers_equal_care_tpu(dataset, tmp_path):
    root = str(tmp_path)
    if dataset == "MSVD":
        args = _msvd(root)
        got, want = da.preprocess_msvd(*args), jax_da.preprocess_msvd(*args)
    elif dataset == "MSRVTT":
        path = _msrvtt(os.path.join(root, "videodatainfo.json"))
        got, want = da.preprocess_msrvtt(path), jax_da.preprocess_msrvtt(path)
    else:
        args = _vatex(root)
        got, want = da.preprocess_vatex(*args), jax_da.preprocess_vatex(*args)
        assert "activate_train" in got["split"]
    _assert_tree_equal(got, want)
    assert got["raw_caps_train"] and got["raw_caps_all"]


@pytest.mark.parametrize("tagger", ["heuristic", "nltk"])
def test_pos_tag_gate_falls_alike(tagger, monkeypatch):
    """Both packages take NLTK's tagger when it answers and the heuristic
    when it raises (here a stand-in tagger marks every word ``JJ``)."""
    import nltk
    if tagger == "nltk":
        monkeypatch.setattr(nltk, "pos_tag",
                            lambda tokens: [(w, "JJ") for w in tokens])
    else:
        def missing(tokens):
            raise LookupError("no tagger data")
        monkeypatch.setattr(nltk, "pos_tag", missing)
    tokens = WORDS + ["slowly", "were", "from"]
    got = corpora._pos_tag(tokens)
    assert got == jax_corpora._pos_tag(tokens)
    want = ([(w, "JJ") for w in tokens] if tagger == "nltk"
            else corpora._heuristic_pos_tag(tokens))
    assert got == want


@pytest.mark.parametrize("attribute_first", [True, False])
def test_prepare_corpus_equals_care_tpu(attribute_first, tmp_path):
    out = da.preprocess_msrvtt(_msrvtt(str(tmp_path / "v.json"), seed=3))
    args = (out["raw_caps_train"], out["raw_caps_all"], out["split"])
    kwargs = dict(count_thr=1, itoc=out["itoc"],
                  attribute_first=attribute_first)
    got = corpora.prepare_corpus(*args, **kwargs)
    want = jax_corpora.prepare_corpus(*args, **kwargs)
    corpora.save_corpus(str(tmp_path / "got.pkl"), got)
    jax_corpora.save_corpus(str(tmp_path / "want.pkl"), want)
    _assert_tree_equal(_load(tmp_path / "got.pkl"),
                       _load(tmp_path / "want.pkl"))
    vocab = corpora.build_vocab(out["raw_caps_train"], 1,
                                attribute_first=attribute_first)
    assert vocab == jax_corpora.build_vocab(
        out["raw_caps_train"], 1, attribute_first=attribute_first)
    if attribute_first:
        stop = set(jax_corpora.get_stop_words_list())
        assert vocab[0] not in stop
    assert corpora.build_references(out["raw_caps_all"]) == \
        jax_corpora.build_references(out["raw_caps_all"])
    assert got["info"]["itow"][constants.BOS] == constants.BOS_WORD


def _glove(path, words, dim=6, seed=4):
    """GloVe lines for ``words`` and every part of the MSRVTT category
    names."""
    rs = np.random.RandomState(seed)
    parts = {p for name in constants.INDEX2CATEGORY.values()
             for p in name.split("/")}
    with open(path, "w", encoding="utf-8") as f:
        for w in list(words) + sorted(parts):
            f.write(w + " " + " ".join(f"{x:.5f}" for x in rs.randn(dim))
                    + "\n")
    return path


def test_category_embeddings_equal_care_tpu(tmp_path):
    path = _glove(str(tmp_path / "glove.txt"), WORDS)
    got = corpora.prepare_category_embeddings(path, 6)
    want = jax_corpora.prepare_category_embeddings(path, 6)
    assert got.shape == (len(constants.INDEX2CATEGORY), 6)
    np.testing.assert_array_equal(got, want)


CORPORA_ARGS = {
    "MSRVTT": lambda root: ["--annotation", _msrvtt(
        os.path.join(root, "videodatainfo.json"))],
    "MSVD": lambda root: (lambda a: ["--annotation", a[0], "--mapping",
                                     a[1]])(_msvd(root)),
    "VATEX": lambda root: (lambda a: [
        "--annotation", a[0], "--val_annotation", a[1], "--mapping", a[2],
        "--frames_root", a[3], "--count_thr", "1",
        "--no_attribute_first"])(_vatex(root)),
}


@pytest.mark.parametrize("dataset", sorted(CORPORA_ARGS))
def test_cli_corpora_writes_care_tpu_files(dataset, tmp_path, monkeypatch):
    argv = ["corpora", "--dataset", dataset] + CORPORA_ARGS[dataset](
        str(tmp_path))
    cli.main(argv + ["--out_dir", str(tmp_path / "port")])
    _run_jax_cli(argv + ["--out_dir", str(tmp_path / "jax")], monkeypatch)
    for name in ("info_corpus.pkl", "refs.pkl"):
        _assert_tree_equal(_load(tmp_path / "port" / name),
                           _load(tmp_path / "jax" / name))


def test_cli_glove_writes_care_tpu_files(tmp_path, monkeypatch):
    argv = ["corpora", "--dataset", "MSRVTT"] + CORPORA_ARGS["MSRVTT"](
        str(tmp_path))
    for side in ("port", "jax"):
        cli.main(argv + ["--out_dir", str(tmp_path / side)])
    itow = _load(tmp_path / "port" / "info_corpus.pkl")["info"]["itow"]
    glove = _glove(str(tmp_path / "glove.txt"),
                   [w for i, w in sorted(itow.items()) if i % 3])
    for side, run in (("port", cli.main),
                      ("jax", lambda a: _run_jax_cli(a, monkeypatch))):
        d = tmp_path / side
        run(["glove", "--glove_txt", glove, "--corpus_dir", str(d),
             "--out", str(d / "glove.npy"), "--categories_out",
             str(d / "categories.npy")])
    for name in ("glove.npy", "categories.npy"):
        got = np.load(tmp_path / "port" / name)
        want = np.load(tmp_path / "jax" / name)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert np.load(tmp_path / "port" / "glove.npy").shape == (len(itow), 6)
    _assert_tree_equal(_load(tmp_path / "port" / "info_corpus.pkl"),
                       _load(tmp_path / "jax" / "info_corpus.pkl"))


@pytest.mark.parametrize("mode", ["mean", "max"])
def test_cli_bert_text_embs_match_care_tpu(mode, tmp_path, monkeypatch):
    from transformers import BertConfig, BertModel
    torch.manual_seed(5)
    model = BertModel(BertConfig(
        vocab_size=len(WORDS) + 5, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=1, intermediate_size=96,
        max_position_embeddings=24)).eval()
    ckpt = str(tmp_path / "bert.pth")
    torch.save(model.state_dict(), ckpt)
    vocab = str(tmp_path / "vocab.txt")
    with open(vocab, "w") as f:
        f.write("\n".join(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
                          + WORDS) + "\n")
    corpus_dir = tmp_path / "corpus"
    cli.main(["corpora", "--dataset", "MSRVTT", "--out_dir", str(corpus_dir)]
             + CORPORA_ARGS["MSRVTT"](str(tmp_path)))
    argv = ["text_embs", "--arch", "bert", "--corpus_dir", str(corpus_dir),
            "--bert_ckpt", ckpt, "--vocab", vocab, "--mode", mode]
    cli.main(argv + ["--out", str(tmp_path / "port" / "BERT.hdf5"),
                     "--device", "cpu"])
    _run_jax_cli(argv + ["--out", str(tmp_path / "jax" / "BERT.hdf5")],
                 monkeypatch)
    with h5py.File(tmp_path / "port" / "BERT.hdf5") as got, \
            h5py.File(tmp_path / "jax" / "BERT.hdf5") as want:
        assert sorted(got) == sorted(want) and len(want) == 12
        for vid in want:
            assert got[vid].shape == want[vid].shape == (4, 64)
            np.testing.assert_allclose(np.asarray(got[vid]),
                                       np.asarray(want[vid]), atol=2e-5,
                                       rtol=1e-4)
