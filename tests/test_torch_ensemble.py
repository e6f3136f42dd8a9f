"""Ensembles of the port (``care_tpu_torch/models/ensemble.py``, the
ensemble decode of ``decoding/translator.py``, ``models/loading.py`` and
``translate.py`` with several ``-cp``) held against the JAX package's on
the same weights (f32, dropout off):

* ``EnsembleSpec``: the modality union and the split of a batch's
  features, and the refusal of shared modalities read from different
  files (``tests/test_ensemble_and_analysis.py:32-53``);
* two models of one modality set, two RNN captioners, and a heterogeneous
  pair (the CARE flagship and PointerGen CARE, one with the retrieved
  captions and one without): beams token-identical with the JAX package's
  averaged log-probabilities (``tests/test_ensemble_and_analysis.py:16``,
  ``tests/test_hetero_ensemble.py:16, :49``), scores within 2e-4; grouped
  (fused-K) decoding equal to batch by batch;
* ``translate`` with two checkpoints and ``--retrieval_db_ratio``, through
  each package's loader on a synthetic dataset with a retrieval database
  (the PointerGen member trained an epoch first, with validation, through
  the port's loader and feature bank):
  the COCO dict equal to the JAX package's ``run_eval`` (``==``), the CSV
  row keeping its ratio.
"""

import csv
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import translate as jax_translate
from care_tpu.data import get_loader as jax_get_loader
from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models.ensemble import EnsembleSpec as JaxEnsembleSpec
from care_tpu_torch import translate as port_translate
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models.ensemble import EnsembleSpec
from care_tpu_torch.models.weights import variables_to_jax
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.checkpoints import save_checkpoint

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import POINTER_COMMANDS, VERS_MSRVTT, tiny_opt

FLAGSHIP = dict(VERS_MSRVTT, method="Transformer", task="CARE")
POINTER_CARE = POINTER_COMMANDS[3][2]
SALSTM = dict(VERS_MSRVTT, method="SALSTM", task="Base")
TOL = 2e-4


def test_ensemble_spec_modality_union():
    o1 = {"modality": "mi", "feats_m": ["m.hdf5"], "feats_i": ["i.hdf5"],
          "dim_m": 8, "dim_i": 8}
    o2 = {"modality": "ai", "feats_a": ["a.hdf5"], "feats_i": ["i.hdf5"],
          "dim_a": 4, "dim_i": 8}
    spec = EnsembleSpec([o1, o2])
    want = JaxEnsembleSpec([o1, o2])
    assert spec.opt == want.opt and spec.need_to_split_feats
    assert spec.opt["modality"] == "mia"
    feats = ["M", "I", "A"]
    assert spec.split_feats(feats) == want.split_feats(feats) == [
        ["M", "I"], ["A", "I"]]
    same = EnsembleSpec([o1, dict(o1)])
    assert not same.need_to_split_feats and same.split_feats(feats) is feats


def test_ensemble_spec_rejects_mismatched_shared_feats():
    o1 = {"modality": "i", "feats_i": ["a.hdf5"], "dim_i": 8}
    o2 = {"modality": "i", "feats_i": ["b.hdf5"], "dim_i": 8}
    with pytest.raises(AssertionError):
        JaxEnsembleSpec([o1, o2])
    with pytest.raises(ValueError, match="modality `i`"):
        EnsembleSpec([o1, o2])


def _decode_both(opt, pairs, batch):
    """(JAX hyps, port hyps, JAX scores, port scores) of the ensemble of
    ``pairs`` on ``batch``."""
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(j, v) for j, v, _ in pairs], batch)
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        [p for _, _, p in pairs], batch)
    return want_h, got_h, want_s, got_s


@pytest.mark.parametrize("overrides", [FLAGSHIP, SALSTM],
                         ids=["Transformer", "SALSTM"])
def test_two_model_ensemble_matches_jax(overrides):
    opt = dict(tiny_opt(overrides), beam_size=3)
    pairs = [flagship_pair(opt, seed=s) for s in (1, 2)]
    batch = {"feats": synthetic_batch(opt, 3, seed=4)["feats"]}
    want_h, got_h, want_s, got_s = _decode_both(opt, pairs, batch)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    # each member alone decodes otherwise: the average is taken
    alone = get_translator(opt, device="cpu").translate_batch(
        pairs[0][2], batch)
    assert alone != (got_h, got_s)


def _hetero_pairs():
    """The CARE flagship (``amir``) and PointerGen CARE (``amirt``) at test
    size, their merged options and spec."""
    opts = [dict(tiny_opt(o), beam_size=3) for o in (FLAGSHIP, POINTER_CARE)]
    assert [o["modality"] for o in opts] == ["amir", "amirt"]
    pairs = [flagship_pair(o, seed=s) for o, s in zip(opts, (1, 2))]
    spec = EnsembleSpec(opts)
    return opts, pairs, spec


def test_heterogeneous_ensemble_matches_jax_and_groups():
    opts, pairs, spec = _hetero_pairs()
    assert spec.need_to_split_feats and spec.opt["modality"] == "amirt"
    opt = {**opts[0], **{k: v for k, v in spec.opt.items()
                         if v is not None}}
    batches = [{"feats": spec.split_feats(
        synthetic_batch(opts[1], n, seed=10 + n)["feats"])}
        for n in (3, 2, 3)]
    assert [len(f) for f in batches[0]["feats"]] == [4, 5]
    want_h, got_h, want_s, got_s = _decode_both(opt, pairs, batches[0])
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    translator = get_translator(opt, device="cpu")
    models = [p for _, _, p in pairs]
    one_by_one = [translator.translate_batch(models, b) for b in batches]
    grouped = [out for _, out in translator.translate_batches_grouped(
        models, enumerate(batches), 2)]
    assert grouped == one_by_one
    assert translator.translate_batches_fused(models, batches) == one_by_one


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """A synthetic dataset with a retrieval database (its ratio-50 copy
    beside it) and the heterogeneous pair saved as port checkpoints,
    PointerGen CARE after an epoch of ``Trainer.fit`` with validation
    through the port's loader and the device feature bank."""
    root = str(tmp_path_factory.mktemp("torch_ensemble"))
    opts, pairs, _ = _hetero_pairs()
    data_dir, paths, corpus, refs = write_synthetic_dataset(
        root, opts[1], n_videos=16)
    assert sorted(paths) == sorted("amirt")
    for p in (paths["r"], paths["t"]):
        shutil.copy(p, p.replace(".hdf5", "_ratio50.0.hdf5"))
    ckpts = []
    for i, (o, (_, _, port)) in enumerate(zip(opts, pairs)):
        o = dict(o, info_corpus=os.path.join(data_dir, "info_corpus.pkl"),
                 reference=os.path.join(data_dir, "refs.pkl"),
                 batch_size=4, epochs=1,
                 checkpoint_path=os.path.join(root, f"m{i}"))
        for c in o["modality"]:
            o[f"feats_{c}"] = [paths[c]]
        if o.get("pointer"):
            tr = Trainer(o, train_loader=get_loader(o, "train"),
                         val_loader=get_loader(o, "validate",
                                               is_validation=True,
                                               not_shuffle=True,
                                               batch_size=4),
                         references=refs, vocab=corpus["info"]["itow"],
                         device="cpu")
            tr.init_model()
            tr.model.load_state_dict(port.state_dict())
            tr.fit()
            assert tr._feature_bank.lookups == len(get_loader(o, "train"))
            assert np.isfinite(tr.history[0]["step_losses"]).all()
            port = tr.model.eval()
        path = os.path.join(root, f"m{i}", "best.ckpt")
        variables = variables_to_jax(port)
        save_checkpoint(path, variables, o)
        ckpts.append((path, o, variables))
    return root, corpus, refs, ckpts


def test_translate_two_checkpoints_with_a_retrieval_ratio(checkpoints,
                                                          tmp_path,
                                                          monkeypatch):
    root, corpus, refs, ckpts = checkpoints
    assert len(corpus["info"]["itow"]) <= ckpts[0][1]["vocab_size"]
    monkeypatch.chdir(tmp_path)
    (scores,) = port_translate.main(
        ["-cp", ckpts[0][0], ckpts[1][0], "--device", "cpu",
         "--batch_size", "4", "--base_data_path", root,
         "--retrieval_db_ratio", "50", "--save_csv",
         "--csv_path", str(tmp_path)])
    with open(tmp_path / "test_result.csv") as f:
        rows = list(csv.DictReader(f))
    assert float(rows[-1]["retrieval_db_ratio"]) == 50.0

    opts = [o for _, o, _ in ckpts]
    jspec = JaxEnsembleSpec(opts)
    jopt = {**opts[0], **{k: v for k, v in jspec.opt.items()
                          if v is not None}}
    for key in ("feats_r", "feats_t"):
        jopt[key] = jopt[key][0].replace(".hdf5", "_ratio50.0.hdf5")
    from care_tpu.models import build_captioner as jax_build
    models = [(jax_build(o), {"params": jax.tree.map(jnp.asarray,
                                                     v["params"])})
              for o, (_, _, v) in zip(opts, ckpts)]
    loader = jax_get_loader(jopt, "test", not_shuffle=True, batch_size=4)
    want, _, _, _, _ = jax_translate.run_eval(
        models, jopt, loader, refs, corpus["info"]["itow"],
        ensemble_spec=jspec)
    assert scores == want
