"""The port's train step on a ``(data, model)`` mesh of processes, held
against ``care_tpu``'s train step on the same mesh of virtual CPU devices.

The port's side runs in one spawned gloo world of four processes
(``torch_parallel_world.py``), the JAX side in this process; both start
from the JAX trainer's initial parameters and take the same numpy batches
(``tests/test_parallel_equivalence.py``'s synthetic corpus), f32, dropout
off (each process of the port draws its own masks). Held as
``test_parallel_equivalence.py`` holds the JAX meshes against one device:
the first step's loss within 1e-6, the trajectory within 1e-3, the
parameters within 5e-3 (the CARE configuration: 1e-5 and 1.2e-3, two
steps).

* ``{data: 4}``, ``{data: 1, model: 2}`` (processes 0-1 of the world) and
  ``{data: 2, model: 2}`` on the Base configuration, three steps; the last
  again with ``gradient_clip_val`` 0.5, so that the clip by global norm
  adds every process's blocks of the split leaves;
* the pure data-parallel step with the fused cross-entropy on equals the
  dense one within 1e-5 (``{data: 2}``, each on its half of the world).
"""

import numpy as np
import pytest
import jax

from care_tpu.data import get_loader
from care_tpu.parallel import make_mesh
from care_tpu.training.trainer import Trainer as JaxTrainer

import torch_parallel_world as world
from test_train_e2e import make_synthetic_env

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}
MESHES = [("dp4", {"data": 4}, None),
          ("tp2", {"data": 1, "model": 2}, [0, 1]),
          ("dptp", {"data": 2, "model": 2}, None),
          ("dptp_clip", {"data": 2, "model": 2}, None)]
# the clip by global norm, whose split leaves count every process's blocks
CLIP = {"dptp_clip": {"gradient_clip_val": 0.5}}
STEPS = 3
# each leaf's change over the steps against the JAX package's, relative
CHANGE_RTOL = 1e-2


def jax_steps(opt, batches, shape):
    """(initial variables, step losses, final variables) of ``care_tpu``'s
    trainer on ``shape`` (None: one device), as ``_run_steps`` drives it."""
    mesh = None
    if shape:
        n = int(np.prod(list(shape.values())))
        mesh = make_mesh(shape, devices=jax.devices("cpu")[:n])
    tr = JaxTrainer(opt, train_loader=world.ListLoader(batches),
                    references=None, vocab=None, mesh=mesh)
    tr.init_model(batches[0])
    tr._build_tx(len(batches))
    step = tr._make_train_step()
    init = jax.tree.map(np.asarray, tr.variables)
    rng = jax.random.PRNGKey(123)
    losses = []
    for b in batches:
        rng, k = jax.random.split(rng)
        params = tr.variables["params"]
        extra = {k2: v for k2, v in tr.variables.items() if k2 != "params"}
        params, mutated, tr.opt_state, loss, _, _ = step(
            params, extra, tr.opt_state, tr._device_batch(b), k, 0.0)
        tr.variables = {"params": params, **extra, **mutated}
        losses.append(float(loss))
    return init, losses, jax.tree.map(np.asarray, tr.variables)


def leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def params_only(got):
    """A run's losses and parameters (its ``batch_stats`` left out)."""
    return {"losses": got["losses"], "variables": got["variables"]["params"]}


def assert_same(want, got, loss_rtol=1e-3, param_atol=5e-3,
                change_rtol=CHANGE_RTOL):
    """``test_parallel_equivalence.py:_assert_same``: the first step
    tightly, the trajectory and the parameters after the steps looser.
    ``want`` is (initial variables, losses, final params). Since an Adam
    step moves an element by about the learning rate, below the parameter
    bound, each leaf's change over the steps is also held to the JAX
    package's change: ``|got - want| <= change_rtol * |want|`` in the
    2-norm (a leaf that does not move in the JAX run must not move). The
    attention key biases are left out of that check: their true gradient
    is 0 (a bias on every key shifts each query's logits alike), so Adam
    turns f32 noise into steps on both sides, and the ground rules hold
    them to the steps times the learning rate, as ``param_atol`` does."""
    np.testing.assert_allclose(got["losses"][0], want[1][0], rtol=1e-6)
    np.testing.assert_allclose(got["losses"], want[1], rtol=loss_rtol)
    w = dict(leaves(want[2]))
    g = dict(leaves(got["variables"]))
    init = dict(leaves(want[0]["params"]))
    assert sorted(w) == sorted(g)
    strays = []
    for name, value in w.items():
        np.testing.assert_allclose(g[name], value, atol=param_atol,
                                   rtol=1e-2, err_msg=name)
        moved = np.linalg.norm(value - init[name])
        off = np.linalg.norm(g[name] - value)
        if not name.endswith("/key/bias") and off > change_rtol * moved:
            strays.append((name, float(off / max(moved, 1e-30))))
    assert not strays, strays


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("torch_parallel_train")
    opt, _, _ = make_synthetic_env(tmp, extra={"epochs": 2,
                                               "batch_size": 8})
    opt.update(NO_DROPOUT)
    loader = get_loader(opt, "train", pad_to_batch=True)
    loader.set_epoch(0)
    batches = list(loader)[:STEPS]
    want = {name: jax_steps(dict(opt, **CLIP.get(name, {})), batches, shape)
            for name, shape, _ in MESHES}
    init = want["dp4"][0]
    configs = [dict(name=name, shape=shape, ranks=ranks,
                    opt=dict(opt, **CLIP.get(name, {})), batches=batches,
                    variables=init)
               for name, shape, ranks in MESHES]
    for fused, ranks in ((True, [0, 1]), (False, [2, 3])):
        configs.append(dict(name=f"dp2_fused_{fused}", shape={"data": 2},
                            ranks=ranks, opt=dict(opt, fused_xent=fused),
                            batches=batches[:1], variables=init))
    got = world.run_world(4, "train_steps", {"configs": configs},
                          str(tmp / "world"))
    return want, got


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_mesh_train_steps_equal_care_tpu(run, name):
    want, got = run
    assert not got[name]["fused"]
    init, losses, final = want[name]
    assert_same((init, losses, final["params"]), params_only(got[name]))
    if name in CLIP:
        # the clip took hold: the second step differs from the unclipped
        assert abs(losses[1] - want["dptp"][1][1]) > 1e-3 * abs(losses[1])


def test_data_parallel_step_runs_fused_xent_equal_to_dense(run):
    _, got = run
    fused, dense = got["dp2_fused_True"], got["dp2_fused_False"]
    assert fused["fused"] and not dense["fused"]
    np.testing.assert_allclose(fused["losses"], dense["losses"], rtol=1e-5)
