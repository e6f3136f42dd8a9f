"""Checkpoint conversion end to end through files, against ``care_tpu``.

* A reference-layout Lightning checkpoint of the CARE flagship at test
  size (``tests/reference_layout.py``) goes through the port's converter
  (``python -m care_tpu_torch.tools.convert_reference_ckpt``) and through
  ``misc_tools/convert_reference_ckpt.py``: the two checkpoints hold
  bit-equal trees and the same opt and metadata, and the port's
  ``translate`` serves its own conversion with the captions that
  ``care_tpu``'s ``load_model`` and ``run_eval`` give for theirs.
* ``--from-teacher`` takes a mean-teacher run's ``teacher_captioner``;
  the converters refuse, with the same message, a checkpoint without an
  opt, a ``--from-teacher`` without teacher keys and an unmapped
  parameter (``--allow-unmapped`` writes it, reporting the key).
* A ``care_tpu`` (msgpack) checkpoint loads through the port's
  ``load_checkpoint`` and ``load_model``, told apart by its bytes, and
  serves the captions ``care_tpu`` serves from it.

f32, dropout off, the CPU.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import translate as jax_translate
from care_tpu.data import get_loader as jax_get_loader
from care_tpu.models import loading as jax_loading
from care_tpu_torch import translate as port_translate
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models import build_captioner, loading
from care_tpu_torch.models.weights import variables_to_jax
from care_tpu_torch.tools import convert_reference_ckpt as port_convert
from care_tpu_torch.training import checkpoints

from reference_layout import lightning_checkpoint, reference_state_dict
from test_torch_support import flagship_small_opt

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "misc_tools"))
import convert_reference_ckpt as jax_convert  # noqa: E402

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A synthetic dataset on disk, the flagship's options over it, and a
    reference-layout Lightning checkpoint of it with a mean teacher."""
    root = str(tmp_path_factory.mktemp("torch_convert"))
    data_dir, paths, corpus, refs = write_synthetic_dataset(
        root, flagship_small_opt(), n_videos=24)
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               beam_size=3, **NO_DROPOUT)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    template = variables_to_jax(build_captioner(opt, device="cpu"))
    student = reference_state_dict(opt, template, seed=11)
    teacher = reference_state_dict(opt, template, seed=12)
    ckpt = os.path.join(root, "ref.ckpt")
    lightning_checkpoint(ckpt, opt, student, teacher)
    return root, opt, corpus, refs, ckpt, student


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_bit_equal(got, want):
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_array_equal(got[path], value, err_msg=path)


def _jax_preds(path, root, refs, vocab):
    """``care_tpu``'s ``load_model`` and ``run_eval`` over the test split;
    returns the captions by video."""
    models, opt = jax_loading.load_model(path, base_data_path=root)
    loader = jax_get_loader(opt, "test", not_shuffle=True, batch_size=4)
    _, _, preds, _, _ = jax_translate.run_eval(models, opt, loader, refs,
                                               vocab)
    return {v: [e["caption"] for e in p] for v, p in preds.items()}


def _port_preds(path, root, out):
    port_translate.main(["-cp", path, "--device", "cpu", "--batch_size",
                         "4", "--base_data_path", root, "--json_path", out])
    with open(os.path.join(out, "preds.json")) as f:
        return {v: [e["caption"] for e in p] for v, p in json.load(f).items()}


def test_converted_checkpoint_serves_like_care_tpu(data, tmp_path,
                                                  monkeypatch):
    root, opt, corpus, refs, ckpt, _ = data
    monkeypatch.chdir(tmp_path)
    ours, theirs = str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt")
    port_convert.main([ckpt, "-o", ours])
    want_report = jax_convert.convert(ckpt, theirs, verbose=False)
    got, got_opt, got_meta = checkpoints.load_checkpoint(ours)
    want, want_opt, want_meta = checkpoints.load_checkpoint(theirs)
    _assert_bit_equal(got, want)
    assert got_opt == want_opt and got_meta == want_meta
    assert got_meta["converted_module"] == "captioner"
    assert want_report["unmapped"] == []

    vocab = corpus["info"]["itow"]
    want_preds = _jax_preds(theirs, root, refs, vocab)
    got_preds = _port_preds(ours, root, str(tmp_path / "out"))
    assert len(got_preds) == len(corpus["info"]["split"]["test"])
    assert got_preds == want_preds
    # the care_tpu (msgpack) conversion through the port's load_model
    assert _port_preds(theirs, root, str(tmp_path / "out_msgpack")) == \
        want_preds


def test_from_teacher_matches_care_tpu(data, tmp_path):
    _, _, _, _, ckpt, _ = data
    ours, theirs = str(tmp_path / "t_port.ckpt"), str(tmp_path / "t_jax.ckpt")
    port_convert.convert(ckpt, ours, from_teacher=True, verbose=False)
    jax_convert.convert(ckpt, theirs, from_teacher=True, verbose=False)
    got, _, meta = checkpoints.load_checkpoint(ours)
    _assert_bit_equal(got, checkpoints.load_checkpoint(theirs)[0])
    assert meta["converted_module"] == "teacher_captioner"
    student = checkpoints.load_checkpoint(
        _convert(ckpt, tmp_path / "s.ckpt"))[0]
    word = ("params", "decoder", "embedding", "word_embeddings")
    assert not np.array_equal(_at(got, word), _at(student, word))


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("case", ["bare", "student_only", "unmapped"])
def test_refusals_match_care_tpu(data, tmp_path, case):
    """No opt (a bare state dict), ``--from-teacher`` without teacher
    keys, an unmapped parameter: the same ``SystemExit`` message."""
    import torch
    _, opt, _, _, _, student = data
    path = str(tmp_path / f"{case}.ckpt")
    kwargs = {}
    if case == "bare":
        torch.save(dict(student), path)
    elif case == "student_only":
        lightning_checkpoint(path, opt, student)
        kwargs["from_teacher"] = True
    else:
        lightning_checkpoint(path, opt, dict(
            student, **{"mystery_module.weight": torch.zeros(3, 3)}))
    with pytest.raises(SystemExit) as got:
        port_convert.convert(path, str(tmp_path / "x.ckpt"), verbose=False,
                             **kwargs)
    with pytest.raises(SystemExit) as want:
        jax_convert.convert(path, str(tmp_path / "y.ckpt"), verbose=False,
                            **kwargs)
    assert str(got.value) == str(want.value)
    if case == "unmapped":
        report = port_convert.convert(path, str(tmp_path / "u.ckpt"),
                                      allow_unmapped=True, verbose=False)
        assert report["unmapped"] == ["mystery_module.weight"]
        _, _, meta = checkpoints.load_checkpoint(str(tmp_path / "u.ckpt"))
        assert meta["unmapped_torch_keys"] == ["mystery_module.weight"]


def _convert(ckpt, out):
    port_convert.convert(ckpt, str(out), verbose=False)
    return str(out)


def test_care_tpu_checkpoint_loads_by_its_bytes(tmp_path, monkeypatch):
    """A ``care_tpu`` checkpoint (flax msgpack) under any name loads as the
    port's own does, with the same side-car; the port's own files still
    load; without the msgpack package the error says what is missing."""
    from care_tpu.models import build_captioner as jax_build_captioner
    from care_tpu.training import checkpoints as jax_checkpoints
    from test_torch_support import randomized, to_numpy

    opt = dict(flagship_small_opt(vocab_size=40), **NO_DROPOUT)
    jmodel = jax_build_captioner(opt)
    template = jax_loading.init_variables_template(jmodel, opt)
    params = randomized(to_numpy(template["params"]), 5)
    path = str(tmp_path / "jax_model.pt")
    jax_checkpoints.save_checkpoint(path, {"params": params}, opt,
                                    metadata={"epoch": 3})
    with open(path, "rb") as f:
        assert checkpoints._is_msgpack(f.read(1))
    got, got_opt, meta = checkpoints.load_checkpoint(path)
    _assert_bit_equal(got, {"params": params})
    assert meta == {"epoch": 3} and got_opt["decoder"] == opt["decoder"]

    models, _ = loading.load_model(path, do_replace_paths=False,
                                   device="cpu")
    _assert_bit_equal(variables_to_jax(models[0]), {"params": params})
    # the port's own format is still read as before
    own = str(tmp_path / "own.ckpt")
    checkpoints.save_checkpoint(own, variables_to_jax(models[0]), opt)
    with open(own, "rb") as f:
        assert not checkpoints._is_msgpack(f.read(1))
    _assert_bit_equal(checkpoints.load_checkpoint(own)[0], {"params": params})

    want = jax.tree.map(np.asarray, jax_checkpoints.load_checkpoint(
        path, jax.tree.map(jnp.asarray, {"params": params}))[0])
    _assert_bit_equal(got, want)

    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError, match="msgpack"):
        checkpoints.load_checkpoint(path)
