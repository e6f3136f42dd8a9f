"""The port's main path as a whole against the JAX package's: a synthetic
dataset on disk (``write_synthetic_dataset``), each package's own
``get_loader``, the same weights (``params_from_jax``) and dropout off.

* ``Trainer.fit`` with validation every epoch: the step losses follow the
  JAX trainer's, and validating the JAX trainer's weights after its epoch
  gives its validation scores;
* validation and the test pass on the same weights: identical beam tokens,
  so the COCO dicts are equal (``==``), and the test pass's analysis, CSV
  row and caption dump too;
* resume: an interrupted and resumed run reproduces the uninterrupted one
  within ``tests/test_resume.py``'s bounds, with dropout on, the dual-Adam
  switch, the plateau rule and random frame sampling;
* ``run(opt, device="cpu")`` end to end, the CLI's refusals, the profiler
  and TensorBoard options.

On the CPU the port's kernels run their plain versions.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.data import get_loader as jax_get_loader
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch import train as port_train
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models.weights import params_from_jax, params_to_jax
from care_tpu_torch.training import Trainer
from test_torch_support import flagship_small_opt, randomized, to_numpy

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}
COCO_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
             "CIDEr", "Sum")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_pipeline"))
    opt = flagship_small_opt()
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=30)
    return root, data_dir, paths, corpus, refs


def _opt(data, tmp_path, **extra):
    _, data_dir, paths, corpus, _ = data
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               batch_size=8, eval_batch_size=4, epochs=1, beam_size=3,
               eval_fused_k=1, device_feature_cache=False)
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


def _pair(data, opt, seed=1):
    """A JAX trainer and a port trainer on one dataset, each with its own
    loaders, holding the same randomized weights."""
    _, _, _, corpus, refs = data
    common = dict(references=refs, vocab=corpus["info"]["itow"])
    jt = JaxTrainer(opt, **_loaders(jax_get_loader, opt), **common)
    jt.init_model(next(iter(jt.train_loader)))
    params = randomized(to_numpy(jt.variables["params"]), seed)
    jt.variables = {"params": jax.tree.map(jnp.asarray, params)}
    pt = Trainer(opt, **_loaders(get_loader, opt), device="cpu", **common)
    pt.init_model()
    params_from_jax(pt.model, params)
    return jt, pt


def _jax_step_losses(jt):
    """Wrap the JAX trainer's step so that it records every step's loss."""
    losses = []
    make = jt._make_train_step

    def make_recording():
        fn = make()

        def step(*args):
            out = fn(*args)
            losses.append(float(out[3]))
            return out
        return step

    jt._make_train_step = make_recording
    return losses


def _assert_coco_equal(got, want):
    for k in COCO_KEYS:
        assert got[k] == want[k], (k, got[k], want[k])


def test_fit_follows_jax_and_validates_like_it(data, tmp_path):
    """Seven steps of one epoch, validation at its end: the losses follow
    the JAX trainer's (1e-4 relative, as ``test_torch_trainer.py``), and the
    port validating the JAX trainer's trained weights gives the JAX
    trainer's validation scores."""
    opt = _opt(data, tmp_path, **NO_DROPOUT)
    jt, pt = _pair(data, opt)
    want_losses = _jax_step_losses(jt)
    jt.fit()
    pt.fit()
    assert len(want_losses) == len(pt.train_loader) == 7
    np.testing.assert_allclose(pt.history[0]["step_losses"], want_losses,
                               rtol=1e-4)
    got_scores = pt.history[0]["scores"]
    want_scores = jt.history[0]["scores"]
    assert set(got_scores) == set(want_scores)
    assert pt.model.training
    assert sorted(os.listdir(opt["checkpoint_path"])) == [
        "best.ckpt", "best.ckpt.json", f"epoch=0_CIDEr="
        f"{got_scores['CIDEr']:.4f}.ckpt",
        f"epoch=0_CIDEr={got_scores['CIDEr']:.4f}.ckpt.json", "last.ckpt",
        "last.ckpt.json"]

    params_from_jax(pt.model, to_numpy(jt.variables["params"]))
    scores = pt.validate(0)
    _assert_coco_equal(scores, want_scores)
    # the concept detector's F1@k and mAP come from the forward in f32 on
    # both sides: 1e-6 relative
    for k in want_scores:
        np.testing.assert_allclose(scores[k], want_scores[k], rtol=1e-6,
                                   err_msg=k)
    assert {"F1-05", "F1-10", "F1-20", "F1-30", "mAP"} <= set(scores)


def test_validation_decodes_the_jax_beams(data, tmp_path):
    opt = _opt(data, tmp_path, **NO_DROPOUT)
    jt, pt = _pair(data, opt, seed=3)
    for jb, pb in zip(jt.val_loader, pt.val_loader):
        want = jt.translate_step(jb)
        pt.model.eval()
        got = pt.translate_step(pb)
        assert list(got) == list(want)
        assert [v[0]["caption"] for v in got.values()] == [
            v[0]["caption"] for v in want.values()]
        for vid in want:
            np.testing.assert_allclose(got[vid][0]["score"],
                                       want[vid][0]["score"], rtol=0,
                                       atol=1e-4)
    # padded rows are dropped: every validation video once
    assert pt.model.training is False
    pt.model.train()
    scores = pt.validate(0)
    want = jt.validate(0)
    _assert_coco_equal(scores, want)
    assert pt.best_scores == {"Sum": scores["Sum"], "CIDEr": scores["CIDEr"]}
    assert pt.model.training


def test_test_pass_matches_jax(data, tmp_path):
    root, _, _, corpus, _ = data
    opt = _opt(data, tmp_path, save_csv=True, csv_name="results",
               **NO_DROPOUT)
    jt, pt = _pair(data, opt, seed=4)
    got_opt = dict(opt, json_path=str(tmp_path / "port_json"),
                   save_detail_scores_path=str(tmp_path / "port_d.json"))
    want_opt = dict(opt, json_path=str(tmp_path / "jax_json"),
                    save_detail_scores_path=str(tmp_path / "jax_d.json"))
    pt.opt, jt.opt = got_opt, want_opt
    got = pt.test(info_corpus=corpus, save_csv_path=str(tmp_path / "p"))
    want = jt.test(info_corpus=corpus, save_csv_path=str(tmp_path / "j"))
    _assert_coco_equal(got, want)
    assert got == want
    assert {"ave_length", "novel", "unique", "usage", "seed"} <= set(got)

    def rows(path):
        with open(path) as f:
            return list(csv.reader(f))
    assert rows(tmp_path / "p" / "results.csv") == rows(
        tmp_path / "j" / "results.csv")
    with open(tmp_path / "port_d.json") as f:
        detail = json.load(f)
    with open(tmp_path / "jax_d.json") as f:
        assert detail == json.load(f)
    # the caption dump: the same captions; each beam score within 1e-4, the
    # bound of the translator tests
    with open(tmp_path / "port_json" / "preds.json") as f:
        preds = json.load(f)
    with open(tmp_path / "jax_json" / "preds.json") as f:
        want_preds = json.load(f)
    assert sorted(preds) == sorted(want_preds)
    for vid, entries in want_preds.items():
        assert [e["caption"] for e in preds[vid]] == [
            e["caption"] for e in entries]
        np.testing.assert_allclose([e["score"] for e in preds[vid]],
                                   [e["score"] for e in entries], rtol=0,
                                   atol=1e-4)


def test_load_best_reloads_the_best_epochs_weights(data, tmp_path):
    """Two epochs keep the better one as ``best.ckpt``; ``load_best`` puts
    exactly its weights back into a model that has moved on."""
    from care_tpu_torch.training.checkpoints import load_checkpoint
    opt = _opt(data, tmp_path, epochs=2, **NO_DROPOUT)
    _, pt = _pair(data, opt)
    pt.fit()
    best = max(pt.history, key=lambda h: h["scores"]["CIDEr"])
    ckpt_dir = opt["checkpoint_path"]
    with open(os.path.join(ckpt_dir, "best.ckpt.json")) as f:
        assert json.load(f)["metadata"]["epoch"] == best["epoch"]
    kept, _, _ = load_checkpoint(os.path.join(
        ckpt_dir, f"epoch={best['epoch']}_CIDEr={best['scores']['CIDEr']:.4f}"
        ".ckpt"))
    with torch.no_grad():
        for p in pt.model.parameters():
            p.add_(1.0)
    pt.load_best()
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(pt.model),
                 kept["params"])
    assert set(COCO_KEYS) <= set(pt.test())


def _run_for_resume(data, tmp_path, epochs, resume, state_dir, extra):
    opt = _opt(data, tmp_path, epochs=epochs, resume=resume,
               train_state_dir=state_dir, **extra)
    _, _, _, corpus, refs = data
    loaders = _loaders(get_loader, opt)
    tr = Trainer(opt, **loaders, references=refs,
                 vocab=corpus["info"]["itow"], device="cpu")
    tr.fit()
    return tr, {h["epoch"]: float(np.mean(h["step_losses"]))
                for h in tr.history}


RESUME_CASES = {
    # dropout on, the dual-Adam switch before the interruption, the plateau
    # rule fed by validation, random frame sampling
    "dense": dict(fused_xent=False, lowlr_start_epoch=1,
                  lr_scheduler_type="plateau", lr_monitor_patience=0,
                  random_type="segment_random", load_feats_type=0),
    "fused": dict(fused_xent=True, fused_xent_chunk=16, lowlr_start_epoch=2,
                  random_type="all_random", n_caps_per_video=2),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_matches_uninterrupted(data, tmp_path, case):
    """As ``tests/test_resume.py``: 3 epochs straight, against 2 epochs
    with the state saved and a fresh trainer resuming to 3; losses rel 1e-5,
    parameters atol 1e-5."""
    extra = RESUME_CASES[case]
    state_dir = str(tmp_path / "state")
    full, full_losses = _run_for_resume(data, tmp_path / "a", 3, False, "",
                                        extra)
    first, first_losses = _run_for_resume(data, tmp_path / "b", 2, True,
                                          state_dir, extra)
    resumed, resumed_losses = _run_for_resume(data, tmp_path / "b", 3, True,
                                              state_dir, extra)
    assert set(resumed_losses) == {2}
    assert first_losses[0] == pytest.approx(full_losses[0], rel=1e-6)
    assert resumed_losses[2] == pytest.approx(full_losses[2], rel=1e-5)
    assert resumed._switched == full._switched
    assert resumed.global_step == full.global_step
    assert resumed.ckpt_manager.topk == [
        (m, p.replace(os.sep + "a" + os.sep, os.sep + "b" + os.sep))
        for m, p in full.ckpt_manager.topk]
    if extra.get("lr_scheduler_type") == "plateau":
        # the scale dropped before the interruption, so the resumed run
        # rebuilt its LR from the saved plateau state
        assert first._plateau.scale < 1.0
        assert (resumed._plateau.scale, resumed._plateau.best) == (
            full._plateau.scale, full._plateau.best)
    assert resumed._fused_xent == full._fused_xent == extra["fused_xent"]
    a, b = params_to_jax(full.model), params_to_jax(resumed.model)
    jax.tree.map(lambda x, y: np.testing.assert_allclose(x, y, atol=1e-5),
                 a, b)


def test_run_end_to_end(data, tmp_path, capsys):
    """``care_tpu_torch.train.run``: train with validation, keep the best,
    reload it, test; the CSV, the TensorBoard log and the checkpoints."""
    opt = _opt(data, tmp_path, epochs=2, save_csv=True, **NO_DROPOUT)
    scores = port_train.run(opt, device="cpu")
    assert set(COCO_KEYS) <= set(scores)
    assert {"ave_length", "novel", "unique", "usage"} <= set(scores)
    files = os.listdir(opt["checkpoint_path"])
    assert {"best.ckpt", "last.ckpt", "test_result.csv"} <= set(files)
    assert "- test scores:" in capsys.readouterr().out
    tb = os.path.join(opt["checkpoint_path"], "tb")
    assert os.path.isdir(tb) and os.listdir(tb)


def test_run_defaults_to_the_card(data, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_train.run(_opt(data, tmp_path))


@pytest.mark.parametrize("argv,name", [
    (["--mesh", "data=2"], "mesh")])
def test_cli_refuses_what_is_not_ported(argv, name, tmp_path, monkeypatch):
    """``--mesh`` is ported; a mesh of two processes in a world of one
    (no ``torchrun``) is refused, naming the mesh and both sizes."""
    monkeypatch.chdir(tmp_path)
    for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match=name):
        port_train.main(["--method", "Transformer", "--task", "CARE",
                         "-dm_flags", "VA", "-pm_flags", "VAT",
                         "--device", "cpu", *argv])


def test_cli_parses_the_reference_flags():
    args = port_train.parse_args([
        "-d", "MSRVTT", "-method", "Transformer", "-task", "CARE",
        "-feats", "ViT", "-dm_flags", "VA", "-pm_flags", "VAT", "-e", "3",
        "--device", "cpu", "--beam_size", "3", "--save_csv"])
    from care_tpu_torch.config.cli import overrides_from_args
    over = overrides_from_args(args, exclude=("override", "mesh", "devices",
                                              "device"))
    assert over["decoder_modality_flags"] == "VA"
    assert over["epochs"] == 3 and over["beam_size"] == 3
    assert over["save_csv"] is True and args.device == "cpu"


def test_profile_dir_traces_steps_five_to_ten(data, tmp_path):
    opt = _opt(data, tmp_path, profile_dir=str(tmp_path / "prof"),
               **NO_DROPOUT)
    tr = Trainer(opt, get_loader(opt, "train"), device="cpu")
    tr.fit()
    assert tr.history[0]["n_steps"] == 7
    with open(tmp_path / "prof" / "trace.json") as f:
        assert json.load(f)["traceEvents"]
