"""The port's serving entry points against the JAX package's: ``load_model``
(``care_tpu_torch/models/loading.py``), ``python -m
care_tpu_torch.translate`` and ``python -m care_tpu_torch.eval_json``, on a
checkpoint the port's ``Trainer`` wrote and a synthetic dataset on disk.

* ``load_model`` round-trips the checkpoint: the same weights, the
  side-car's opt with the overrides, the model in eval mode;
* ``replace_paths`` and ``modify_opt_if_necessary`` equal the JAX
  package's on the same opt;
* ``translate.main`` on the CPU writes the predictions JSON, the detail
  scores, the CSV row and the ``latency.txt`` line; its COCO dict equals
  the JAX package's ``run_eval`` on the same weights and data (``==``),
  with and without ``--fused_k``;
* ``eval_json`` prints the scores of ``run_eval``;
* what is not ported raises with its name.
"""

import csv
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import translate as jax_translate
from care_tpu.data import get_loader as jax_get_loader
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.models import loading as jax_loading
from care_tpu_torch import eval_json as port_eval_json
from care_tpu_torch import translate as port_translate
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.models import loading
from care_tpu_torch.models.weights import params_to_jax
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.checkpoints import load_checkpoint
from test_torch_support import flagship_small_opt



@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One epoch of the port's Trainer on a synthetic dataset; returns the
    data root, the corpus, the references and the best checkpoint."""
    root = str(tmp_path_factory.mktemp("torch_entry"))
    opt = flagship_small_opt()
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=30)
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               batch_size=8, eval_batch_size=4, epochs=1, beam_size=3,
               hidden_dropout_prob=0.0, encoder_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    opt["checkpoint_path"] = os.path.join(root, "exps")
    tr = Trainer(opt, train_loader=get_loader(opt, "train"),
                 val_loader=get_loader(opt, "validate", is_validation=True,
                                       not_shuffle=True, batch_size=4,
                                       pad_to_batch=True),
                 references=refs, vocab=corpus["info"]["itow"], device="cpu")
    tr.fit()
    ckpt = os.path.join(opt["checkpoint_path"], "best.ckpt")
    assert os.path.exists(ckpt)
    return root, corpus, refs, ckpt, params_to_jax(tr.model)


def test_load_model_round_trips_a_trainer_checkpoint(trained):
    root, _, _, ckpt, params = trained
    models, opt = loading.load_model(ckpt, {"beam_size": 2},
                                     base_data_path=root, device="cpu")
    assert len(models) == 1 and not models[0].training
    assert opt["beam_size"] == 2
    _, saved_opt, _ = load_checkpoint(ckpt)
    assert opt["info_corpus"] == saved_opt["info_corpus"]
    jax.tree.map(np.testing.assert_array_equal, params_to_jax(models[0]),
                 params)
    models, opt, spec = loading.load_model(ckpt, base_data_path=root,
                                           return_spec=True, device="cpu")
    assert spec is None and opt["beam_size"] == 3


def test_path_rewrites_equal_jax():
    opt = {"dataset": "MSRVTT", "info_corpus": "/a/b/MSRVTT/info.pkl",
           "reference": "/a/b/MSRVTT/refs.pkl",
           "feats_m": ["/a/b/MSRVTT/feats/m.hdf5"],
           "feats_r": "/a/b/MSRVTT/feats/CLIP_ViT-B-32_unique.hdf5",
           "feats_t": ["/a/b/MSRVTT/feats/t.hdf5"]}
    for base in (None, "/data"):
        assert loading.replace_paths(json.loads(json.dumps(opt)), base) == \
            jax_loading.replace_paths(json.loads(json.dumps(opt)), base)
    for args in ((["MSRVTT"], 100), (["VATEX", "MSVD"], 50.0), ([], 20)):
        assert loading.modify_opt_if_necessary(
            json.loads(json.dumps(opt)), *args) == \
            jax_loading.modify_opt_if_necessary(
                json.loads(json.dumps(opt)), *args)


def _jax_run_eval(opt, params, refs, vocab, **kwargs):
    jmodel = jax_build_captioner(opt)
    variables = {"params": jax.tree.map(jnp.asarray, params)}
    loader = jax_get_loader(opt, "test", not_shuffle=True, batch_size=4)
    return jax_translate.run_eval([(jmodel, variables)], opt, loader, refs,
                                  vocab, **kwargs)


def test_translate_main_writes_and_scores_like_jax(trained, tmp_path,
                                                   monkeypatch):
    root, corpus, refs, ckpt, params = trained
    monkeypatch.chdir(tmp_path)
    out = str(tmp_path / "out")
    common = ["-cp", ckpt, "--device", "cpu", "--batch_size", "4",
              "--base_data_path", root]
    (fused,) = port_translate.main(common + [
        "--fused_k", "2", "--json_path", out, "--json_name", "fused.json"])
    (piped,) = port_translate.main(common + [
        "--json_path", out, "--save_csv", "--csv_path", out,
        "--save_detail_scores_path", os.path.join(out, "detail.json")])
    assert fused == piped
    with open(os.path.join(out, "fused.json")) as f:
        fused_preds = json.load(f)
    with open(os.path.join(out, "preds.json")) as f:
        preds = json.load(f)
    assert fused_preds == preds
    with open(os.path.join(out, "detail.json")) as f:
        assert set(json.load(f)) == set(preds)      # per-video scores
    with open(os.path.join(out, "test_result.csv")) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 1 and rows[0]["mode"] == "test"
    assert float(rows[0]["CIDEr"]) == pytest.approx(piped["CIDEr"])

    _, opt = loading.load_model(ckpt, base_data_path=root, device="cpu")
    want, _, want_preds, _, n = _jax_run_eval(opt, params, refs,
                                              corpus["info"]["itow"])
    assert n == len(preds) == len(corpus["info"]["split"]["test"])
    assert piped == want
    assert {k: [{"caption": e["caption"]} for e in v]
            for k, v in preds.items()} == {
        k: [{"caption": e["caption"]} for e in v]
        for k, v in want_preds.items()}

    port_translate.main(common + ["--latency"])
    with open(tmp_path / "latency.txt") as f:
        lines = f.read().splitlines()
    assert len(lines) == 1
    method, task, total, n_videos, avg = lines[0].split("\t")
    assert (method, task) == (opt["method"], opt["task"])
    assert int(n_videos) == n and float(total) > 0 and float(avg) > 0


def test_eval_json_prints_run_eval_scores(trained, tmp_path, capsys):
    root, corpus, refs, ckpt, _ = trained
    models, opt = loading.load_model(ckpt, base_data_path=root, device="cpu")
    loader = get_loader(opt, "test", not_shuffle=True, batch_size=4)
    scores, _, preds, _, _ = port_translate.run_eval(
        models, opt, loader, refs, corpus["info"]["itow"], device="cpu")
    path = str(tmp_path / "preds.json")
    with open(path, "w") as f:
        json.dump(preds, f)
    capsys.readouterr()
    got = port_eval_json.main(["-json", path, "-ref", opt["reference"]])
    assert got == scores
    printed = capsys.readouterr().out.splitlines()
    assert printed == [f"{k}: {v:.4f}" for k, v in scores.items()]


def test_loading_refuses_ensembles_and_defaults_to_the_card(trained,
                                                            monkeypatch):
    root, _, _, ckpt, _ = trained
    with pytest.raises(NotImplementedError, match="ensembles"):
        port_translate.main(["-cp", ckpt, ckpt, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="ensembles"):
        loading.load_model([ckpt, ckpt], device="cpu")
    # strict=False used to raise; on a complete checkpoint it loads what
    # the strict load does
    loose, _ = loading.load_model(ckpt, base_data_path=root, strict=False,
                                  device="cpu")
    strict, _ = loading.load_model(ckpt, base_data_path=root, device="cpu")
    for a, b in zip(loose[0].parameters(), strict[0].parameters()):
        assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        loading.load_model(ckpt, base_data_path=root)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_translate.main(["-cp", ckpt, "--base_data_path", root])
