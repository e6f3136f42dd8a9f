"""The port's forward, beam search and ``Trainer.fit`` on meshes of
processes, held against ``care_tpu`` on the same meshes and against the
port without a mesh.

One spawned gloo world of four processes (``torch_parallel_world.py``)
serves every check of this file; the JAX side runs in this process on its
virtual CPU devices.

* the eval-mode logits on ``{data: 2}`` and ``{data: 1, model: 2}``
  within 2e-4 of ``care_tpu``'s on the same mesh (``test_sharding.py``);
* beam search on ``{data: 2}`` and ``{data: 2, model: 2}``, each process
  decoding its rows, token-identical to ``care_tpu``'s sharded decode and
  scores within 1e-4 (``test_sharded_decode.py``). On the model axis each
  process streams its half of the vocabulary through the fused head's
  plain path and the halves merge; two equal head rows, one in each half,
  make the merge break a tie between the shards (lower id first);
* the flagship with ``RPE`` and its hybrid bias on the model axis: each
  process adds its heads' block of both, logits within 2e-4 and beams as
  above;
* ``Trainer.fit`` for an epoch with validation on ``{data: 2}`` and on
  ``{data: 2, model: 2}``: the COCO scores equal (``==``) those of the port
  without a mesh validating the same weights (the epoch's losses follow
  the mesh-less epoch's), the concept metrics (f32 sums over other row
  blocks) within 1e-6; the best checkpoint, written by
  the first process, loads into a single-process model ``torch.equal`` to
  the gathered parameters, and on ``{data: 2, model: 2}`` the train state
  resumes to every process's blocks;
* ``torchrun --nproc_per_node 2 -m care_tpu_torch.train --mesh
  data=1,model=2 --device cpu`` trains, validates and tests the flagship
  end to end on a synthetic dataset.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.parallel import (make_mesh, shard_batch, shard_params,
                               DATA_AXIS, MODEL_AXIS)
from care_tpu_torch.data.corpus import write_synthetic_dataset

import torch_parallel_world as world
from helpers import cpu_subprocess_env, tiny_opt, tiny_model_and_batch
from test_torch_parallel_train import NO_DROPOUT
from test_torch_support import (flagship_pair, flagship_small_opt,
                                randomized, synthetic_batch, to_numpy)

FORWARD_MESHES = [("dp2", {DATA_AXIS: 2}, [0, 1]),
                  ("tp2", {DATA_AXIS: 1, MODEL_AXIS: 2}, [2, 3])]
DECODE_MESHES = [("dp2", {DATA_AXIS: 2}, [0, 1]),
                 ("dptp", {DATA_AXIS: 2, MODEL_AXIS: 2}, None)]
COCO_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
             "CIDEr", "Sum")
TIE = (7, 27)     # one row in each half of a vocabulary of 40


def _jax_mesh(shape):
    n = int(np.prod(list(shape.values())))
    return make_mesh(shape, devices=jax.devices("cpu")[:n])


def _forward_case():
    opt = tiny_opt(dim_hidden=64, num_attention_heads=4,
                   intermediate_size=128)
    model, variables, batch = tiny_model_and_batch(opt, batch_size=4)
    variables = {"params": randomized(to_numpy(variables["params"]), 1)}
    want = {}
    for name, shape, _ in FORWARD_MESHES:
        mesh = _jax_mesh(shape)
        vs, b = shard_params(variables, mesh), shard_batch(batch, mesh)
        with mesh:
            want[name] = np.asarray(jax.jit(lambda v, x: model.apply(
                v, x, deterministic=True, collect_aux=False)["logits"])(
                    vs, b))
    payload = {"opt": opt, "variables": variables, "meshes": FORWARD_MESHES,
               "batch": jax.tree.map(np.asarray, batch)}
    return want, payload


def _decode_case():
    opt = tiny_opt(vocab_size=40, beam_size=3, topk=2, dim_hidden=32,
                   num_attention_heads=4, intermediate_size=64)
    model, variables, batch = tiny_model_and_batch(opt, batch_size=4,
                                                   seed=7)
    params = to_numpy(variables["params"])
    kernel = params["cls_head"]["tgt_word_prj"]["kernel"]
    kernel[:, TIE[0]] = 3.0 * kernel[:, TIE[0]]
    kernel[:, TIE[1]] = kernel[:, TIE[0]]
    variables = {"params": params}
    want = {}
    for name, shape, _ in DECODE_MESHES:
        mesh = _jax_mesh(shape)
        vs = shard_params(variables, mesh)
        feats = shard_batch({"feats": batch["feats"]}, mesh)["feats"]
        with mesh:
            want[name] = jax_get_translator(opt).translate_batch(
                [(model, vs)], {"feats": feats})
    payload = {"opt": opt, "variables": variables, "meshes": DECODE_MESHES,
               "feats": [np.asarray(f) for f in batch["feats"]]}
    return want, payload


def _rpe_case():
    """The flagship at test widths with relative-position biases (and its
    hybrid bias): each process adds its heads' block of both, in the full
    forward and in the KV-cached beam step."""
    opt = dict(flagship_small_opt(), RPE=True, max_relative_position=3)
    jmodel, variables, _ = flagship_pair(opt, seed=5)
    batch = synthetic_batch(opt, 4, seed=6)
    mesh = _jax_mesh({DATA_AXIS: 1, MODEL_AXIS: 2})
    vs = shard_params(variables, mesh)
    with mesh:
        logits = np.asarray(jax.jit(lambda v, x: jmodel.apply(
            v, x, deterministic=True, collect_aux=False)["logits"])(
                vs, shard_batch(batch, mesh)))
    mesh = _jax_mesh({DATA_AXIS: 2, MODEL_AXIS: 2})
    vs = shard_params(variables, mesh)
    feats = shard_batch({"feats": batch["feats"]}, mesh)["feats"]
    with mesh:
        beams = jax_get_translator(opt).translate_batch(
            [(jmodel, vs)], {"feats": feats})
    forward = {"opt": opt, "variables": variables, "batch": batch,
               "meshes": [("tp2", {DATA_AXIS: 1, MODEL_AXIS: 2}, [0, 1])]}
    decode = {"opt": opt, "variables": variables, "feats": batch["feats"],
              "meshes": [("dptp", {DATA_AXIS: 2, MODEL_AXIS: 2}, None)]}
    return logits, beams, forward, decode


def _fit_case(root):
    data_dir, paths, corpus, _ = write_synthetic_dataset(
        root, flagship_small_opt(), n_videos=30)

    def opt_for(name):
        opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
                   batch_size=8, eval_batch_size=4, epochs=1, beam_size=3,
                   **NO_DROPOUT)
        opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
        opt["reference"] = os.path.join(data_dir, "refs.pkl")
        for c, p in paths.items():
            opt[f"feats_{c}"] = [p]
        opt["checkpoint_path"] = os.path.join(root, name)
        opt["resume"] = name == "dptp"
        return opt

    return {"configs": [
        dict(name=name, shape=shape, ranks=ranks, opt=opt_for(name))
        for name, shape, ranks in DECODE_MESHES]}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel_decode")
    want_logits, forward = _forward_case()
    want_beams, decode = _decode_case()
    rpe_logits, rpe_beams, rpe_forward, rpe_decode = _rpe_case()
    got = world.run_world(4, "several", [
        ("forward_logits", "forward_logits", forward),
        ("beam_search", "beam_search", decode),
        ("rpe_logits", "forward_logits", rpe_forward),
        ("rpe_beams", "beam_search", rpe_decode),
        ("fit", "fit", _fit_case(str(tmp / "data")))], str(tmp / "world"))
    return {"logits": want_logits, "beams": want_beams,
            "rpe_logits": rpe_logits, "rpe_beams": rpe_beams}, got


@pytest.mark.parametrize("name", [m[0] for m in FORWARD_MESHES])
def test_forward_logits_on_mesh_match_care_tpu(run, name):
    want, got = run
    np.testing.assert_allclose(got["forward_logits"][name],
                               want["logits"][name], rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", [m[0] for m in DECODE_MESHES])
def test_sharded_beam_search_matches_care_tpu(run, name):
    want, got = run
    hyps, scores = got["beam_search"][name]
    want_hyps, want_scores = want["beams"][name]
    assert hyps == want_hyps
    for a, b in zip(scores, want_scores):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    # the tied rows, one in each half of the vocabulary, both reached
    tokens = {t for h in hyps for hyp in h for t in hyp}
    assert set(TIE) <= tokens


def test_relative_position_bias_on_model_axis_matches_care_tpu(run):
    want, got = run
    np.testing.assert_allclose(got["rpe_logits"]["tp2"], want["rpe_logits"],
                               rtol=0, atol=2e-4)
    hyps, scores = got["rpe_beams"]["dptp"]
    assert hyps == want["rpe_beams"][0]
    for a, b in zip(scores, want["rpe_beams"][1]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.parametrize("name", [m[0] for m in DECODE_MESHES])
def test_trainer_fit_on_mesh_scores_as_without(run, name):
    _, got = run
    out = got["fit"][name]
    assert out["n_steps"] > 0
    # the epoch's steps, each process on its rows of every batch, follow
    # the mesh-less epoch (test_parallel_equivalence.py's bounds)
    np.testing.assert_allclose(out["losses"][0], out["plain_losses"][0],
                               rtol=1e-6)
    np.testing.assert_allclose(out["losses"], out["plain_losses"],
                               rtol=1e-3)
    assert {k: out["scores"][k] for k in COCO_KEYS} == {
        k: out["single"][k] for k in COCO_KEYS}
    assert sorted(out["scores"]) == sorted(out["single"])
    for k in set(out["scores"]) - set(COCO_KEYS):
        np.testing.assert_allclose(out["scores"][k], out["single"][k],
                                   rtol=1e-6, err_msg=k)
    assert bool(out["split"]) == (name == "dptp")


@pytest.mark.parametrize("name", [m[0] for m in DECODE_MESHES])
def test_mesh_checkpoint_loads_whole_into_one_process(run, name):
    """The whole best checkpoint; on the model axis also the train state
    (the whole parameters, Adam moments, every process's generators),
    which a fresh trainer on the mesh resumes to each process's blocks,
    ``torch.equal`` (checked in the world)."""
    _, got = run
    equal = got["fit"][name]["ckpt_equal"]
    assert equal and all(equal.values()), [k for k, v in equal.items()
                                            if not v]
    assert got["fit"][name]["resumed"] == (True if name == "dptp" else None)


def test_train_cli_runs_under_torchrun(tmp_path):
    """The CLI on a mesh of two processes over gloo, at the flagship's
    widths on 24 synthetic videos, one epoch: every process exits 0 and
    the first writes the checkpoints and prints the test scores."""
    from care_tpu_torch.config import get_opt
    root = str(tmp_path / "data")
    over = {"dataset": "MSRVTT", "method": "Transformer", "task": "CARE",
            "feats": "ViT", "decoder_modality_flags": "VA",
            "predictor_modality_flags": "VAT", "base_data_path": root}
    opt = get_opt(over, read_vocab=False)
    data_dir, paths, _, _ = write_synthetic_dataset(root, opt, n_videos=24)
    # the synthetic stores under the names the presets resolve
    for c in "ami":
        os.symlink(paths[c], opt[f"feats_{c}"][0])
    os.makedirs(os.path.dirname(opt["feats_r"]), exist_ok=True)
    os.symlink(paths["r"], opt["feats_r"])
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "care_tpu_torch.train",
           "--mesh", "data=1,model=2", "--device", "cpu",
           "--base_data_path", root, "-method", "Transformer", "-task",
           "CARE", "-feats", "ViT", "-dm_flags", "VA", "-pm_flags", "VAT",
           "-e", "1", "-b", "8", "--override",
           '{"eval_batch_size": 8, "beam_size": 2}']
    env = cpu_subprocess_env({"OMP_NUM_THREADS": "1",
                              "PYTHONPATH": os.path.dirname(
                                  os.path.dirname(os.path.abspath(
                                      __file__)))})
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count("- test scores:") == 1, out.stdout
    files = {f: os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "exps")
             for f in fs}
    assert "best.ckpt" in files
    with open(files["test_result.csv"]) as f:
        assert len(f.read().strip().splitlines()) == 2     # header, one row
