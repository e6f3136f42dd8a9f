"""Pretreatment against the JAX package (``care_tpu/pretreatment/
{retrieval,frames}.py`` and ``pretreatment_cli.py``).

Retrieval: the top-k indices equal ``care_tpu``'s, ties included (every
similarity of the tie fixtures is exact in f32, so equal values are equal
in both packages, and the lower caption index must come first, as
``lax.top_k`` orders them); the own-range and duplicate filters, the
database's HDF5 layout and the evaluation's metrics equal. Frames: the
``ffmpeg`` gate, without it and with a stand-in on the PATH. The CLI:
``image_feats`` (ResNet-18 and CLIP), ``text_embs --arch clip`` and
``retrieval`` of the port against ``care_tpu``'s CLI on the same inputs,
features within the CNN suite's bounds (2e-4 absolute, 1e-3 relative),
retrieval datasets equal; ``corpora``, ``glove`` and ``--arch bert``,
refused by name until they were ported, now read their inputs.
"""

import gzip
import os
import pickle
import stat
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

import pretreatment_cli as jax_cli
from care_tpu.data.corpus import (build_synthetic_corpus,
                                  build_synthetic_references)
from care_tpu.pretreatment import frames as jax_frames
from care_tpu.pretreatment import retrieval as jax_retrieval
from care_tpu_torch import pretreatment_cli as cli
from care_tpu_torch.pretreatment import frames, retrieval

from test_cnn import _randomize_bn_stats
from test_torch_clip import MERGES, _openai_state_dict
from torch_cnn_mirror import TorchResNet


def _ternary(n, d, nonzero, seed):
    """Rows with ``nonzero`` entries of +-1: unit norm once normalised by an
    exact power of two, so every cosine is a multiple of 1 / nonzero, exact
    in f32, and ties are plentiful."""
    rs = np.random.RandomState(seed)
    x = np.zeros((n, d), np.float32)
    for row in x:
        cols = rs.choice(d, nonzero, replace=False)
        row[cols] = rs.choice([-1.0, 1.0], nonzero)
    return x


def test_topk_breaks_ties_lowest_index_first():
    sims = torch.tensor([[1.0, 3.0, 3.0, 3.0, 2.0, 3.0],
                         [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
                         [5.0, 4.0, 3.0, 2.0, 1.0, 0.0],
                         [2.0, 1.0, 2.0, 1.0, 2.0, 1.0]])
    for k in (1, 2, 3, 4, 6):
        _, want = jax.lax.top_k(jnp.asarray(sims.numpy()), k)
        got = retrieval.topk_lowest_index(sims, k)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("data", ["ties", "random"])
def test_retrieve_topk_matches_jax(data):
    if data == "ties":
        image, text = _ternary(12, 32, 4, 0), _ternary(300, 32, 4, 1)
    else:
        rs = np.random.RandomState(2)
        image = rs.randn(12, 32).astype(np.float32)
        text = rs.randn(300, 32).astype(np.float32)
    k = 120
    _, want = jax_retrieval._sims_topk(
        jnp.asarray(jax_retrieval.l2_normalize(image)),
        jnp.asarray(jax_retrieval.l2_normalize(text)), k)
    got = retrieval.sims_topk(image, text, k, device="cpu")
    np.testing.assert_array_equal(got, np.asarray(want))

    refs = [f"caption {i % 170}" for i in range(300)]      # duplicates
    own = [(25 * i, 25 * i + 25) for i in range(12)]
    for unique in (False, True):
        assert retrieval.retrieve_topk(
            image, text, 5, own_ranges=own, refs=refs, unique=unique,
            candidate_factor=2, device="cpu") == jax_retrieval.retrieve_topk(
            image, text, 5, own_ranges=own, refs=refs, unique=unique,
            candidate_factor=2)


@pytest.mark.parametrize("data", ["ties", "random"])
def test_evaluate_retrieval_matches_jax(data):
    if data == "ties":
        image, text = _ternary(10, 16, 4, 3), _ternary(200, 16, 4, 4)
    else:
        rs = np.random.RandomState(5)
        image = rs.randn(10, 16).astype(np.float32)
        text = np.repeat(image, 20, axis=0) + rs.randn(200, 16).astype(
            np.float32)
    own = [(20 * i, 20 * i + 20) for i in range(10)]
    # care_tpu's ranks: the stable double argsort
    sims = np.asarray(jnp.einsum(
        "id,td->it", jnp.asarray(jax_retrieval.l2_normalize(image)),
        jnp.asarray(jax_retrieval.l2_normalize(text))))
    rank = np.asarray(jnp.argsort(jnp.argsort(-sims, axis=1), axis=1))
    for i, got in enumerate(retrieval.own_caption_ranks(image, text, own,
                                                        device="cpu")):
        np.testing.assert_array_equal(got, rank[i, own[i][0]:own[i][1]])
    assert retrieval.evaluate_retrieval(image, text, own, device="cpu") \
        == jax_retrieval.evaluate_retrieval(image, text, own)


def test_build_retrieval_db_matches_jax(tmp_path):
    image, text = _ternary(6, 16, 4, 6), _ternary(60, 16, 4, 7)
    store = np.random.RandomState(8).randn(60, 8).astype(np.float32)
    refs = [f"c{i % 40}" for i in range(60)]
    own = [(10 * i, 10 * i + 10) for i in range(6)]
    keys = [f"video{i}" for i in range(6)]
    paths = [str(tmp_path / "port.hdf5"), str(tmp_path / "jax.hdf5")]
    ids = retrieval.build_retrieval_db(paths[0], keys, image, text, store, 4,
                                       own_ranges=own, refs=refs,
                                       device="cpu")
    assert ids == jax_retrieval.build_retrieval_db(
        paths[1], keys, image, text, store, 4, own_ranges=own, refs=refs)
    _assert_same_hdf5(*paths, atol=0)


def test_video_embeddings_match_jax():
    embs = np.random.RandomState(9).randn(60, 8).astype(np.float32)
    np.testing.assert_array_equal(
        retrieval.video_embeddings_from_frames(embs, 28),
        jax_retrieval.video_embeddings_from_frames(embs, 28))


def test_frames_gate(tmp_path, monkeypatch):
    """Without ``ffmpeg`` a video yields no frames, or raises with
    ``strict``; with one on the PATH (a stand-in script writing three
    frames) both packages run it and count what it wrote."""
    video_dir = tmp_path / "videos"
    video_dir.mkdir()
    for name in ("video0.mp4", "video1.avi", "notes.txt"):
        (video_dir / name).write_text("")
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert not frames.has_ffmpeg()
    assert frames.extract_frames_for_dataset(str(video_dir),
                                             str(tmp_path / "f")) == 0
    with pytest.raises(RuntimeError, match="ffmpeg"):
        frames.extract_frames(str(video_dir / "video0.mp4"),
                              str(tmp_path / "f0"), strict=True)

    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    fake = bin_dir / "ffmpeg"
    # shell builtins only: the PATH holds nothing but this script
    fake.write_text("#!/bin/sh\nfor last; do :; done\nd=\"${last%/*}\"\n"
                    "for i in 1 2 3; do : > \"$d/0000$i.jpg\"; done\n")
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("PATH", str(bin_dir))
    assert frames.has_ffmpeg()
    for mod, out in ((frames, "port"), (jax_frames, "jax")):
        assert mod.extract_frames_for_dataset(
            str(video_dir), str(tmp_path / out), fps=5) == 6
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax")) == ["video0", "video1"]


# ---------------------------------------------------------------------------
# the CLI against care_tpu's
# ---------------------------------------------------------------------------

def _assert_same_hdf5(path_a, path_b, atol, rtol=0.0):
    with h5py.File(path_a) as a, h5py.File(path_b) as b:
        assert sorted(a.keys()) == sorted(b.keys())
        for key in a.keys():
            x, y = np.asarray(a[key]), np.asarray(b[key])
            assert x.shape == y.shape and x.dtype == y.dtype, key
            if key.endswith("_i"):
                np.testing.assert_array_equal(x, y, err_msg=key)
            else:
                np.testing.assert_allclose(x, y, rtol=rtol, atol=atol,
                                           err_msg=key)


def _run_jax_cli(argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["pretreatment_cli.py"] + argv)
    jax_cli.main()


@pytest.fixture(scope="module")
def clip_ckpt(tmp_path_factory):
    """An OpenAI-named CLIP checkpoint at the shapes ``care_tpu``'s CLI
    builds (ViT-B/32's patch 32, width 768 and 224 x 224 input, 512-wide
    output, the 49 408-word text table) with one layer per tower and a
    64-wide text tower."""
    sd = _openai_state_dict(11, width=768, layers=1, patch=32, t_width=64,
                            t_layers=1, vocab=49408, ctx=77, out=512,
                            side=224)
    path = str(tmp_path_factory.mktemp("clip") / "clip.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def _frames_dir(root):
    rs = np.random.RandomState(12)
    for v in range(2):
        d = root / "frames" / f"video{v}"
        d.mkdir(parents=True)
        for f in range(5):
            Image.fromarray((rs.rand(64, 48, 3) * 255).astype(
                np.uint8)).save(d / f"{f:04d}.jpg")
    return str(root / "frames")


@pytest.mark.parametrize("model", ["resnet18", "clip"])
def test_image_feats_cli_matches_jax(model, clip_ckpt, tmp_path,
                                     monkeypatch):
    frames_dir = _frames_dir(tmp_path)
    if model == "clip":
        ckpt = ["--clip_ckpt", clip_ckpt]
    else:
        torch.manual_seed(7)
        path = str(tmp_path / "resnet18.pth")
        torch.save(_randomize_bn_stats(TorchResNet(depth=18).eval(),
                                       seed=7).state_dict(), path)
        ckpt = ["--cnn_ckpt", path]
    argv = ["image_feats", "--frames_dir", frames_dir, "--model", model,
            "--k", "3", *ckpt]
    cli.main(argv + ["--out", str(tmp_path / "port.hdf5"), "--device",
                     "cpu"])
    _run_jax_cli(argv + ["--out", str(tmp_path / "jax.hdf5")], monkeypatch)
    _assert_same_hdf5(str(tmp_path / "port.hdf5"),
                      str(tmp_path / "jax.hdf5"), atol=2e-4, rtol=1e-3)
    with h5py.File(tmp_path / "port.hdf5") as hf:
        assert hf["video0"].shape == (3, 512)


def test_text_embs_cli_matches_jax(clip_ckpt, tmp_path, monkeypatch):
    bpe_path = str(tmp_path / "merges.txt.gz")
    with gzip.open(bpe_path, "wt", encoding="utf-8") as f:
        f.write("\n".join(MERGES) + "\n")
    refs = {"video0": [{"caption": "a man and a dog"}],
            "video1": [{"caption": "the cat is running"},
                       {"caption": "playing with a cat"}]}
    corpus_dir = tmp_path / "MSRVTT"
    corpus_dir.mkdir()
    with open(corpus_dir / "refs.pkl", "wb") as f:
        pickle.dump(refs, f)
    argv = ["text_embs", "--corpus_dir", str(corpus_dir), "--arch", "clip",
            "--clip_ckpt", clip_ckpt, "--bpe", bpe_path]
    cli.main(argv + ["--out", str(tmp_path / "port.hdf5"), "--device",
                     "cpu"])
    _run_jax_cli(argv + ["--out", str(tmp_path / "jax.hdf5")], monkeypatch)
    _assert_same_hdf5(str(tmp_path / "port.hdf5"),
                      str(tmp_path / "jax.hdf5"), atol=2e-4, rtol=1e-3)
    with h5py.File(tmp_path / "port.hdf5") as hf:
        assert hf["video1"].shape == (2, 512)


def test_retrieval_cli_matches_jax(tmp_path, monkeypatch):
    corpus = build_synthetic_corpus(n_videos=8, max_len=12)
    refs = build_synthetic_references(corpus)
    with open(tmp_path / "info_corpus.pkl", "wb") as f:
        pickle.dump(corpus, f)
    with open(tmp_path / "refs.pkl", "wb") as f:
        pickle.dump(refs, f)
    rs = np.random.RandomState(13)
    with h5py.File(tmp_path / "img.hdf5", "w") as hf:
        for i in range(8):
            hf.create_dataset("video%d" % i,
                              data=rs.randn(60, 16).astype(np.float32))
    with h5py.File(tmp_path / "txt.hdf5", "w") as hf:
        for i in range(8):
            n = len(refs["video%d" % i])
            hf.create_dataset("video%d" % i,
                              data=rs.randn(n, 16).astype(np.float32))
    argv = ["retrieval", "--corpus_dir", str(tmp_path),
            "--image_embs", str(tmp_path / "img.hdf5"),
            "--text_embs", str(tmp_path / "txt.hdf5"), "--topk", "3",
            "--n_frames", "8"]
    cli.main(argv + ["--out", str(tmp_path / "port.hdf5"), "--device",
                     "cpu"])
    _run_jax_cli(argv + ["--out", str(tmp_path / "jax.hdf5")], monkeypatch)
    _assert_same_hdf5(str(tmp_path / "port.hdf5"),
                      str(tmp_path / "jax.hdf5"), atol=0)


@pytest.mark.parametrize("argv,name", [
    (["corpora", "--dataset", "MSRVTT", "--annotation", "a.json",
      "--out_dir", "out"], "corpora"),
    (["glove", "--glove_txt", "g.txt", "--corpus_dir", "c", "--out",
      "e.npy"], "glove"),
    (["text_embs", "--corpus_dir", "c", "--arch", "bert", "--out",
      "b.hdf5"], "bert")])
def test_cli_refuses_what_is_not_ported(argv, name, tmp_path, monkeypatch):
    """``corpora``, ``glove`` and ``--arch bert`` used to be refused by
    name; they are ported now (``tests/test_torch_text_pretreatment.py``
    holds them to ``care_tpu``'s CLI), so each runs until it reads its
    missing input file."""
    monkeypatch.chdir(tmp_path)
    if name == "bert":
        argv = argv + ["--bert_ckpt", "b.pth", "--vocab", "v.txt"]
    with pytest.raises(FileNotFoundError):
        cli.main(argv)
