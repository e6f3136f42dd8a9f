"""The mean teacher of the port (``care_tpu_torch/training/mean_teacher.py``)
against ``care_tpu``'s ``MeanTeacherTrainer``, on a synthetic dataset on
disk read by each package's own loader, the same carried weights (the
student's and another set for the teacher, so that the distillation term
is not zero), f32 and dropout off:

* two epochs of ``fit`` with validation every epoch: each step's
  distillation loss and total loss (1e-4 relative, as
  ``tests/test_torch_trainer.py``), the student's and the teacher's
  parameters after the run (2e-5 absolute; the attention key biases,
  whose true gradient is 0, within the steps taken times the learning
  rate, the rule of ``tests/test_torch_paper_grid_train.py``), the best
  scores (``==``);
* which weights each decode and file takes, as in ``care_tpu``:
  validation decodes the student, every checkpoint holds the teacher's
  parameters (``last.ckpt`` exactly the final teacher, ``best.ckpt``
  within 2e-5 of ``care_tpu``'s), ``test`` after ``load_best`` decodes the
  teacher in memory and leaves the model's weights as they were; its
  captions equal ``care_tpu``'s;
* the EMA update is ``ema * t + (1 - ema) * s`` exactly, and the step takes
  the dense logits (no fused cross-entropy);
* ``care_tpu_torch.train.run`` with ``wrapper: InterplayModel`` trains,
  validates, checkpoints and tests through the mean teacher.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.data import get_loader as jax_get_loader
from care_tpu.training.mean_teacher import (
    MeanTeacherTrainer as JaxMeanTeacherTrainer)
from care_tpu_torch import train as port_train
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models.weights import params_from_jax, params_to_jax
from care_tpu_torch.training import checkpoints
from care_tpu_torch.training.mean_teacher import MeanTeacherTrainer
from care_tpu_torch.training.trainer import device_batch
from test_torch_support import flagship_small_opt, randomized, to_numpy

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_mean_teacher"))
    data_dir, paths, corpus, refs = write_synthetic_dataset(
        root, flagship_small_opt(), n_videos=20)
    return root, data_dir, paths, corpus, refs


def _opt(data, tmp_path, **extra):
    _, data_dir, paths, corpus, _ = data
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               batch_size=8, eval_batch_size=4, epochs=2, beam_size=3,
               eval_fused_k=1, device_feature_cache=False,
               wrapper="InterplayModel", distillation_weight=0.5,
               **NO_DROPOUT)
    opt.update(extra)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    opt["checkpoint_path"] = str(tmp_path / "exps")
    return opt


def _loaders(get, opt):
    return dict(
        train_loader=get(opt, "train"),
        val_loader=get(opt, "validate", is_validation=True, not_shuffle=True,
                       batch_size=opt["eval_batch_size"], pad_to_batch=True),
        test_loader=get(opt, "test", not_shuffle=True,
                        batch_size=opt["eval_batch_size"], pad_to_batch=True))


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_close(got, want, atol, key_bias_atol):
    """Leaf by leaf within ``atol``; the attention key biases, whose true
    gradient is 0 (Adam turns rounding noise into steps of the learning
    rate), within ``key_bias_atol``, as
    ``tests/test_torch_paper_grid_train.py`` holds them."""
    got = dict(_leaves(got))
    for path, value in _leaves(want):
        np.testing.assert_allclose(
            got[path], value, rtol=0, err_msg=path,
            atol=key_bias_atol if path.endswith("/key/bias") else atol)


def _recording(trainer, index):
    """Wrap ``trainer._make_train_step`` so that every step's outputs
    ``(loss, losses)`` are recorded; ``index`` is where the step's tuple
    holds the loss (the losses dict follows it)."""
    record = []
    make = trainer._make_train_step

    def make_recording():
        fn = make()

        def step(*args):
            out = fn(*args)
            record.append((float(out[index]), float(
                out[index + 1]["Distillation Loss"])))
            return out
        return step

    trainer._make_train_step = make_recording
    return record


def _pair(data, opt):
    """``care_tpu``'s mean-teacher trainer and the port's on one dataset,
    each with its own loaders, the student's and the teacher's weights
    carried from one random draw each."""
    _, _, _, corpus, refs = data
    common = dict(references=refs, vocab=corpus["info"]["itow"])
    jax_opt = dict(opt, checkpoint_path=opt["checkpoint_path"] + "_jax")
    jt = JaxMeanTeacherTrainer(jax_opt, **_loaders(jax_get_loader, opt),
                               **common)
    jt.init_model(next(iter(jt.train_loader)))
    student = randomized(to_numpy(jt.variables["params"]), 1)
    teacher = randomized(to_numpy(jt.variables["params"]), 2)
    jt.variables = {"params": jax.tree.map(jnp.asarray, student)}
    jt.teacher_variables = {"params": jax.tree.map(jnp.asarray, teacher)}
    pt = MeanTeacherTrainer(opt, **_loaders(get_loader, opt), device="cpu",
                            **common)
    pt.init_model()
    params_from_jax(pt.model, teacher)
    pt.teacher_params = {n: p.detach().clone()
                         for n, p in pt.model.named_parameters()}
    params_from_jax(pt.model, student)
    return jt, pt


def _spy_decodes(pt):
    """Record, at every decode, whether the model held the teacher's
    weights (the vocab head's, compared exactly)."""
    name = "cls_head.tgt_word_prj.weight"
    seen = []
    translator = pt.translator

    def spy(method):
        inner = getattr(translator, method)

        def wrapped(model, *args, **kwargs):
            seen.append((method, torch.equal(
                model.get_parameter(name), pt.teacher_params[name])))
            return inner(model, *args, **kwargs)
        setattr(translator, method, wrapped)

    spy("translate_batches_grouped")
    spy("translate_batch")
    return seen


def test_mean_teacher_follows_care_tpu(data, tmp_path):
    root, _, _, corpus, _ = data
    opt = _opt(data, tmp_path)
    jt, pt = _pair(data, opt)
    want = _recording(jt, 4)
    got = _recording(pt, 0)
    seen = _spy_decodes(pt)
    jt.fit()
    pt.fit()
    n_steps = 2 * len(pt.train_loader)
    assert len(got) == len(want) == n_steps and pt.global_step == n_steps
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert all(d > 0 for _, d in got)
    assert pt._fused_xent is False
    noise = n_steps * opt["learning_rate"]
    _assert_close(params_to_jax(pt.model), to_numpy(jt.variables["params"]),
                  2e-5, noise)
    teacher = params_to_jax(pt.model, pt.teacher_params)
    _assert_close(teacher, to_numpy(jt.teacher_variables["params"]), 2e-5,
                  noise)
    assert pt.best_scores == jt.best_scores
    # validation decoded the student, once a batch each epoch
    assert seen == [("translate_batches_grouped", False)] * 2

    # every checkpoint holds the teacher: last.ckpt exactly the final one
    ckpt_dir = opt["checkpoint_path"]
    last, _, _ = checkpoints.load_checkpoint(os.path.join(ckpt_dir,
                                                          "last.ckpt"))
    for path, value in _leaves(teacher):
        np.testing.assert_array_equal(dict(_leaves(last["params"]))[path],
                                      value, err_msg=path)
    best, _, meta = checkpoints.load_checkpoint(os.path.join(ckpt_dir,
                                                             "best.ckpt"))
    want_best, _, want_meta = checkpoints.load_checkpoint(
        os.path.join(jt.ckpt_manager.ckpt_dir, "best.ckpt"))
    assert meta["epoch"] == want_meta["epoch"]
    _assert_close(best, want_best, 2e-5, noise)

    # load_best then test: the teacher in memory decodes; the model keeps
    # the best checkpoint's weights
    pt.load_best()
    jt.load_best()
    loaded = params_to_jax(pt.model)
    pt.opt = dict(opt, json_path=str(tmp_path / "port_json"))
    jt.opt = dict(jt.opt, json_path=str(tmp_path / "jax_json"))
    got_scores = pt.test(info_corpus=corpus)
    want_scores = jt.test(info_corpus=corpus)
    assert got_scores == want_scores
    assert set(seen[2:]) == {("translate_batch", True)}
    for path, value in _leaves(params_to_jax(pt.model)):
        np.testing.assert_array_equal(dict(_leaves(loaded))[path], value)
    preds = {}
    for side in ("port_json", "jax_json"):
        with open(tmp_path / side / "preds.json") as f:
            preds[side] = {v: [e["caption"] for e in p]
                           for v, p in json.load(f).items()}
    assert preds["port_json"] == preds["jax_json"]
    assert len(preds["port_json"]) == len(corpus["info"]["split"]["test"])


def test_ema_update_and_student_eval(data, tmp_path):
    """One step: the teacher is ``ema * t0 + (1 - ema) * s1`` with the
    step's own rounding; with ``eval_model: student`` the checkpoint and
    ``test`` take the student."""
    opt = _opt(data, tmp_path, ema_weight=0.9, eval_model="student")
    _, pt = _pair(data, opt)
    t0 = {n: t.clone() for n, t in pt.teacher_params.items()}
    pt._build_tx(len(pt.train_loader))
    batch = device_batch(next(iter(pt.train_loader)), "cpu")
    pt.model.train()
    pt._make_train_step()(batch)
    for n, s in pt.model.named_parameters():
        want = 0.9 * t0[n] + (1 - 0.9) * s.detach()
        assert torch.equal(pt.teacher_params[n], want), n
    student = params_to_jax(pt.model)
    for path, value in _leaves(pt._eval_variables()["params"]):
        np.testing.assert_array_equal(dict(_leaves(student))[path], value)
    seen = _spy_decodes(pt)
    pt.model.eval()
    pt.translate_step(next(iter(pt.test_loader)))
    assert seen == [("translate_batch", False)]


def test_run_trains_the_mean_teacher(data, tmp_path, capsys, monkeypatch):
    """``care_tpu_torch.train.run`` with ``wrapper: InterplayModel``: the
    mean-teacher trainer fits two epochs with validation, keeps the
    teacher's checkpoints, reloads the best and tests."""
    made = []
    init = MeanTeacherTrainer.__init__

    def spy(self, *args, **kwargs):
        made.append(self)
        init(self, *args, **kwargs)

    monkeypatch.setattr(MeanTeacherTrainer, "__init__", spy)
    opt = _opt(data, tmp_path, save_csv=True)
    scores = port_train.run(opt, device="cpu")
    (trainer,) = made
    assert trainer.global_step == 2 * len(trainer.train_loader)
    assert {"CIDEr", "Bleu_4", "METEOR", "ROUGE_L", "Sum",
            "ave_length"} <= set(scores)
    files = os.listdir(opt["checkpoint_path"])
    assert {"best.ckpt", "last.ckpt", "test_result.csv"} <= set(files)
    last, _, _ = checkpoints.load_checkpoint(
        os.path.join(opt["checkpoint_path"], "last.ckpt"))
    teacher = params_to_jax(trainer.model, trainer.teacher_params)
    for path, value in _leaves(teacher):
        np.testing.assert_array_equal(dict(_leaves(last["params"]))[path],
                                      value)
    out = capsys.readouterr().out
    assert "- epoch 1: loss=" in out and "- test scores:" in out
