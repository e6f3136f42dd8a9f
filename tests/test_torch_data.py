"""The port's data pipeline (``care_tpu_torch.data``) against the JAX
package's (``care_tpu.data``): caption targets, frame samplers and corpus
builders on seeded inputs, the synthetic dataset's files, and the batches of
``get_loader`` for train, validate and test over two epochs, key by key,
before any model runs. Everything here is numpy: the comparisons are exact.
"""

import os
import pickle

import h5py
import numpy as np
import pytest

from care_tpu.config import get_opt as jax_get_opt
from care_tpu.data import corpus as jax_corpus
from care_tpu.data import loader as jax_loader
from care_tpu.data import samplers as jax_samplers
from care_tpu.data import text as jax_text
from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.data import corpus, loader, samplers, text


def assert_same(a, b, path="batch"):
    """Exact equality of nested dicts, lists and numpy arrays, types too."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b and type(a) is type(b), (path, a, b)


# ---------------------------------------------------------------------------
# caption targets and samplers
# ---------------------------------------------------------------------------

CAPTION = [constants.BOS, 8, 9, 10, 30, 31, 11, constants.EOS]
TAGS = [0, 1, 2, 2, 3, 0, 1, 0]


def _syn_vocab():
    c = corpus.build_synthetic_corpus(n_videos=4, seed=0)
    return c["info"]["itow"], c["info"]["itop"]


TEXT_CASES = {
    "padding": lambda m, rs: [m.padding(CAPTION, n, add_eos=e)
                              for n in (4, 8, 12) for e in (True, False)],
    "ar_train": lambda m, rs: m.make_source_target(
        CAPTION, TAGS, 12, "train", "ARFormer", rs),
    "mlm_train": lambda m, rs: [m.make_source_target(
        CAPTION, TAGS, 12, "train", "NARFormer", rs, beta=(0.2, 0.9))
        for _ in range(5)],
    "mlm_eval": lambda m, rs: m.make_source_target(
        CAPTION, TAGS, 12, "validate", "NARFormer", rs),
    "visual_word": lambda m, rs: [m.make_source_target(
        CAPTION, TAGS, 12, "train", t, rs, visual_word_generation=True,
        itow=_syn_vocab()[0], itop=_syn_vocab()[1])
        for t in ("ARFormer", "NARFormer")],
    "visual_taggings": lambda m, rs: m.prepare_tgt_visual_taggings(
        CAPTION, TAGS, *_syn_vocab(), 12),
    "non_stop_words": lambda m, rs: m.prepare_non_stop_words_mask(
        CAPTION[1:] + [0, 0], _syn_vocab()[0], corpus.STOP_WORDS),
    "attribute_mask": lambda m, rs: [m.prepare_attribute_mask(CAPTION, k)
                                     for k in (None, 5, 25)],
    "vid2attr": lambda m, rs: m.vid2attribute_mappings(
        [0, 1, 2], corpus.build_synthetic_corpus(n_videos=3)["captions"]),
}


@pytest.mark.parametrize("case", sorted(TEXT_CASES))
def test_text_matches_jax(case):
    fn = TEXT_CASES[case]
    got = fn(text, np.random.RandomState(3))
    want = fn(jax_text, np.random.RandomState(3))
    assert_same(got, want)


@pytest.mark.parametrize("random_type", ["all_random", "segment_random",
                                         "equally_sampling"])
@pytest.mark.parametrize("n_total,n_frames", [(60, 8), (60, 28), (9, 9)])
def test_frame_ids_match_jax(random_type, n_total, n_frames):
    """Ten draws in a row from one RandomState each: the same frame ids."""
    a, b = np.random.RandomState(7), np.random.RandomState(7)
    for _ in range(10):
        assert (samplers.get_frame_ids(n_total, n_frames, random_type, a)
                == jax_samplers.get_frame_ids(n_total, n_frames, random_type,
                                              b))


def test_resampling_and_uniform_items_match_jax():
    for src, tgt in ((5, 8), (60, 28), (7, 7)):
        assert samplers.resampling(src, tgt) == jax_samplers.resampling(src,
                                                                        tgt)
    items = list("abcdefghijklmnop")
    assert (samplers.get_uniform_items_from_k_snippets(items, 5)
            == jax_samplers.get_uniform_items_from_k_snippets(items, 5))
    with pytest.raises(ValueError, match="random_type"):
        samplers.get_frame_ids(60, 8, "nope")


# ---------------------------------------------------------------------------
# corpus
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kwargs", [
    dict(n_videos=40), dict(n_videos=25, n_caps_per_video=5, seed=3),
    dict(n_videos=10, consistent=True, seed=1)])
def test_synthetic_corpus_and_references_match_jax(kwargs):
    got = corpus.build_synthetic_corpus(**kwargs)
    want = jax_corpus.build_synthetic_corpus(**kwargs)
    assert got == want
    assert (corpus.build_synthetic_references(got)
            == jax_corpus.build_synthetic_references(want))


@pytest.mark.parametrize("mode", ["train", "validate", "test", "all",
                                  "trainval"])
def test_ids_set_matches_jax(mode):
    split = corpus.build_synthetic_corpus(n_videos=20)["info"]["split"]
    vatex = dict(split, **{f"activate_{m}": split[m][:2]
                           for m in ("train", "validate", "test")})
    for kwargs in ({}, {"is_vatex_activate": True}):
        s = vatex if kwargs else split
        if mode in ("all", "trainval") and kwargs:
            continue
        assert (corpus.get_ids_set(mode, s, **kwargs)
                == jax_corpus.get_ids_set(mode, s, **kwargs))


def _tiny_opt(**extra):
    overrides = {"dataset": "MSRVTT", "method": "Transformer", "task": "CARE",
                 "feats": "ViT", "decoder_modality_flags": "VA",
                 "predictor_modality_flags": "VAT", "max_len": 12,
                 "n_frames": 8, "batch_size": 8, "attribute_prediction_k": 25,
                 "use_attr_topk": 5, **extra}
    opt = get_opt(overrides, read_vocab=False, resolve_paths=False)
    assert opt == jax_get_opt(overrides, read_vocab=False,
                              resolve_paths=False)
    opt["dim_a"], opt["dim_m"], opt["dim_i"], opt["dim_r"] = 8, 16, 12, 12
    return opt


def _hdf5_contents(path):
    with h5py.File(path, "r") as f:
        return {k: np.asarray(f[k]) for k in f}


def test_write_synthetic_dataset_matches_jax(tmp_path):
    opt = _tiny_opt()
    got = corpus.write_synthetic_dataset(str(tmp_path / "port"), opt,
                                         n_videos=12, seed=4)
    want = jax_corpus.write_synthetic_dataset(str(tmp_path / "jax"), opt,
                                              n_videos=12, seed=4)
    assert got[2] == want[2] and got[3] == want[3]
    assert sorted(got[1]) == sorted(want[1]) == sorted(opt["modality"])
    for name in ("info_corpus.pkl", "refs.pkl"):
        with open(os.path.join(got[0], name), "rb") as f:
            a = pickle.load(f)
        with open(os.path.join(want[0], name), "rb") as f:
            assert a == pickle.load(f)
    for char in got[1]:
        a, b = _hdf5_contents(got[1][char]), _hdf5_contents(want[1][char])
        assert_same(a, b, char)
        assert all(v.shape == (constants.N_TOTAL_FRAMES, opt[f"dim_{char}"])
                   for v in a.values())


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_data"))
    opt = _tiny_opt()
    data_dir, paths, _, _ = corpus.write_synthetic_dataset(root, opt,
                                                           n_videos=30)
    return data_dir, paths


def _data_opt(dataset, **extra):
    data_dir, paths = dataset
    opt = _tiny_opt(**extra)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    return opt


LOADER_CASES = {
    # the flagship's sampling: equally spaced frames, every caption
    "train_flagship": (dict(), dict(mode="train")),
    "train_random": (dict(random_type="segment_random", n_caps_per_video=2,
                          load_feats_type=0), dict(mode="train")),
    "train_all_random": (dict(random_type="all_random",
                              load_feats_type=1), dict(mode="train")),
    "validate_padded": (dict(), dict(mode="validate", is_validation=True,
                                     not_shuffle=True, batch_size=5,
                                     pad_to_batch=True)),
    "validate_all_caps": (dict(), dict(mode="validate", is_validation=True,
                                       all_caps=True, not_shuffle=True,
                                       batch_size=4)),
    "test_padded": (dict(), dict(mode="test", not_shuffle=True, batch_size=4,
                                 pad_to_batch=True)),
    "test_one_batch": (dict(), dict(mode="test", not_shuffle=True,
                                    batch_size=64, pad_to_batch=True)),
}


@pytest.mark.parametrize("case", sorted(LOADER_CASES))
def test_loader_batches_match_jax(dataset, case):
    """Two epochs of batches from both packages' ``get_loader`` on one
    dataset: equal key by key (feats, frame ids, targets, masks,
    ``labels_attr``, ``batch_mask``)."""
    extra, kwargs = LOADER_CASES[case]
    opt = _data_opt(dataset, **extra)
    kwargs = dict(kwargs)
    mode = kwargs.pop("mode")
    got = loader.get_loader(opt, mode, **kwargs)
    want = jax_loader.get_loader(opt, mode, **kwargs)
    assert len(got) == len(want) > 0
    seen_pad = False
    for epoch in (0, 1):
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        a, b = list(got), list(want)
        assert len(a) == len(b) == len(got)
        for x, y in zip(a, b):
            assert_same(x, y)
            seen_pad |= not x["batch_mask"].all()
    ragged = len(got.dataset) % got.batch_size != 0
    assert seen_pad == (ragged and kwargs.get("pad_to_batch", False))
    if mode == "train":
        # the shuffle changes with the epoch
        got.set_epoch(0)
        first = next(iter(got))["video_ids"]
        got.set_epoch(1)
        assert next(iter(got))["video_ids"] != first


def test_loader_reads_the_hdf5_features(dataset):
    """A sample's features are the HDF5 rows at its frame ids; a video
    missing from the file is zero-filled."""
    data_dir, paths = dataset
    opt = _data_opt(dataset, load_feats_type=0)
    ds = loader.get_loader(opt, "test", not_shuffle=True).dataset
    sample = ds[0]
    vid, frame_ids = sample["video_ids"], sample["frame_ids"]
    with h5py.File(paths["i"], "r") as f:
        want = np.asarray(f[vid])[frame_ids]
    i = opt["modality"].index("i")
    np.testing.assert_array_equal(sample["feats"][i], want)
    missing = ds._load_feats(ds.databases[i][1:], "video9999",
                             frame_ids=frame_ids)
    assert missing.shape == (opt["n_frames"], opt["dim_i"])
    assert not missing.any()


def test_prefetch_yields_in_order_and_raises_the_workers_error():
    assert list(loader.prefetch(iter(range(7)), n=2)) == list(range(7))

    def broken():
        yield 1
        raise KeyError("video7")

    it = loader.prefetch(broken(), n=1)
    assert next(it) == 1
    with pytest.raises(KeyError, match="video7"):
        next(it)
