"""The CARE configuration and ARB's BatchNorm on a mesh of processes, held
against ``care_tpu``'s train step on the same mesh.

One spawned gloo world of four processes serves both checks
(``torch_parallel_world.py``); f32 and dropout off on both sides.

* the configuration of ``test_parallel_equivalence.py``'s
  ``test_care_tp_train_step_equals_single_device`` (concept heads,
  semantic container, multi-task loss) on ``{data: 2, model: 2}``: two
  steps, the first loss within 1e-6, the
  losses within 1e-5 and the parameters within 1.2e-3, that test's bounds
  (an Adam step moves an element by up to the learning rate, and a 1e-7
  gradient drift can flip the sign of a near-zero element's step);
* ARB (``BN1d`` in its encoder) on ``{data: 2}``: the statistics are the
  whole global batch's, so three steps follow ``care_tpu``'s mesh run,
  the running statistics included (``batch_stats`` within 1e-5);
* semantic composition (``compositional_intra`` and ``compositional_ffn``,
  whose ``CompositionalLinear`` maps run whole on every process while the
  inter attention and the encoder split) on ``{data: 1, model: 2}``: three
  steps, held as the Base meshes are.
"""

import numpy as np
import pytest

from care_tpu.data import get_loader

import torch_parallel_world as world
from test_torch_parallel_train import (NO_DROPOUT, assert_same, jax_steps,
                                       leaves, params_only)
from test_torch_compositional import GLSG
from test_torch_support import synthetic_batch
from test_train_e2e import make_synthetic_env
from torch_paper_grid import tiny_opt


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel_care")
    care, _, _ = make_synthetic_env(
        tmp, task="CARE",
        extra={"decoder_modality_flags": "V",
               "predictor_modality_flags": "V", "epochs": 1,
               "batch_size": 8})
    care.update(NO_DROPOUT)
    loader = get_loader(care, "train", pad_to_batch=True)
    loader.set_epoch(0)
    care_batches = list(loader)[:2]
    arb = tiny_opt(dict(dataset="MSRVTT", arch="base", method="ARB",
                        task="Base", feats="ViT", modality="ami",
                        final_overrides=NO_DROPOUT))
    arb_batches = [synthetic_batch(arb, 8, seed=20 + i) for i in range(3)]
    sc = tiny_opt(dict(GLSG, use_attr_flags="G0Lc",
                       add_hybrid_attention_bias=True,
                       final_overrides=dict(NO_DROPOUT,
                                            compositional_intra=True,
                                            compositional_ffn=True)))
    sc_batches = [synthetic_batch(sc, 8, seed=30 + i) for i in range(3)]
    want = {"care": jax_steps(care, care_batches,
                              {"data": 2, "model": 2}),
            "arb": jax_steps(arb, arb_batches, {"data": 2}),
            "sc": jax_steps(sc, sc_batches, {"data": 1, "model": 2})}
    configs = [dict(name="care", shape={"data": 2, "model": 2}, ranks=None,
                    opt=care, batches=care_batches,
                    variables=want["care"][0]),
               dict(name="arb", shape={"data": 2}, ranks=[0, 1], opt=arb,
                    batches=arb_batches, variables=want["arb"][0]),
               dict(name="sc", shape={"data": 1, "model": 2}, ranks=[2, 3],
                    opt=sc, batches=sc_batches, variables=want["sc"][0])]
    got = world.run_world(4, "train_steps", {"configs": configs},
                          str(tmp / "world"))
    return want, got


def test_care_train_step_on_dp_tp_mesh_equals_care_tpu(run):
    want, got = run
    init, losses, final = want["care"]
    assert_same((init, losses, final["params"]), params_only(got["care"]),
                loss_rtol=1e-5, param_atol=1.2e-3)


def test_arb_batch_norm_on_data_mesh_equals_care_tpu(run):
    want, got = run
    init, losses, final = want["arb"]
    assert_same((init, losses, final["params"]), params_only(got["arb"]))
    w = dict(leaves(final["batch_stats"]))
    g = dict(leaves(got["arb"]["variables"]["batch_stats"]))
    assert sorted(w) == sorted(g) and w
    for name, value in w.items():
        np.testing.assert_allclose(g[name], value, rtol=0, atol=1e-5,
                                   err_msg=name)


def test_compositional_train_step_on_model_mesh_equals_care_tpu(run):
    want, got = run
    init, losses, final = want["sc"]
    assert_same((init, losses, final["params"]), params_only(got["sc"]))
