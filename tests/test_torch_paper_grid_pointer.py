"""The PointerGen commands of the paper grid
(``torch_paper_grid.POINTER_COMMANDS``: the four PointerGen lines of
``scripts/exp_versatility_of_CARE.sh``), built in both packages at test
size and held against each other.

Each case checks that both packages' loaders make the same options (the
``t`` stream of retrieved captions appended to the modalities), that the
full forward's logits and log-probabilities agree within 2e-4, and that
beam search, which takes the pointer's dense step, gives token-identical
beams, scores within 2e-4. The MSRVTT Base line trains three steps in both
packages from the same weights, as ``test_torch_paper_grid_train.py``
holds the other families: losses within 1e-4 relative, the first step's
gradients within 1e-3 relative + 1e-6 absolute, the parameters after the
three updates within 2e-5 (the attention key biases, whose true gradient
is zero, within three learning rates). f32, dropout off.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from care_tpu.config import get_opt as jax_get_opt
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.models.weights import (grads_to_jax, params_to_jax,
                                           variables_from_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import (POINTER_COMMANDS, case_ids, held_against_jax,
                              tiny_opt)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("overrides", [c[2] for c in POINTER_COMMANDS],
                         ids=case_ids(POINTER_COMMANDS))
def test_pointer_command_matches_jax(overrides):
    opt = tiny_opt(overrides)
    assert opt == tiny_opt(overrides, jax_get_opt)
    assert opt["pointer"] == "Pointer" and opt["modality"].endswith("t")
    err, want_h, got_h, want_s, got_s = held_against_jax(opt)
    assert err <= 2e-4, err
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-4)


def test_pointer_grid_covers_the_scripts():
    """The four PointerGen lines, each citing the line that runs its
    dataset and task."""
    assert len({c[0] for c in POINTER_COMMANDS}) == 4
    for _, where, overrides in POINTER_COMMANDS:
        path, line = where.split(":")
        with open(os.path.join(REPO, path)) as f:
            text = f.readlines()[int(line) - 1]
        assert "--method PointerGen " in text, where
        assert text.rstrip().rstrip('"').endswith(
            f"--task {overrides['task']}"), where
        assert ("msvd" in text) == (overrides["dataset"] == "MSVD")


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def test_pointer_command_trains_as_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, where, overrides = POINTER_COMMANDS[1]
    opt = dict(tiny_opt(overrides), epochs=1,
               checkpoint_path=str(tmp_path / "exps"))
    jmodel, variables, _ = flagship_pair(opt, seed=5)
    batches = [synthetic_batch(opt, 4, seed=10 + i) for i in range(3)]

    crit = JaxCriterion(opt)

    def loss_fn(p):
        jb = jax.tree.map(jnp.asarray, batches[0])
        outputs = jmodel.apply({"params": p}, jb, deterministic=True)

        def project_fn(feats, flag):
            return jmodel.apply({"params": p}, feats, flag,
                                method=type(jmodel).project_attribute)
        return crit({**outputs, **jb}, project_fn)[0]

    want_loss0, want_grads = jax.jit(jax.value_and_grad(loss_fn))(
        variables["params"])
    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    params, opt_state, want_losses = jt.variables["params"], jt.opt_state, []
    rng = jax.random.PRNGKey(1)
    for b in batches:
        rng, k = jax.random.split(rng)
        params, _, opt_state, loss, _, _ = step(
            params, {}, opt_state, jax.tree.map(jnp.asarray, b), k, 0.0)
        want_losses.append(float(loss))
    np.testing.assert_allclose(want_losses[0], float(want_loss0), rtol=1e-5)

    # the port: the pointer keeps the dense cross-entropy under both
    # settings of fused_xent that would otherwise fuse
    for fx in ("auto", True):
        tr = Trainer(dict(opt, fused_xent=fx), ListLoader(batches),
                     device="cpu")
        tr.init_model()
        tr._make_train_step()
        assert not tr._fused_xent
    tr = Trainer(opt, ListLoader(batches), device="cpu")
    tr.init_model()
    variables_from_jax(tr.model, variables)
    model = tr.model
    tb = device_batch(batches[0], "cpu")
    outputs = model(tb)
    assert "probs" in outputs
    total, _, _ = Criterion(opt)({**outputs, **tb}, model.project_attribute)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss0), rtol=2e-5)
    got = dict(_leaves(grads_to_jax(model)))
    want = dict(_leaves(jax.tree.map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)
    assert any(p.startswith("pointer/") for p in want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-3,
                                   atol=1e-6, err_msg=f"{where} {path}")
    model.zero_grad()

    tr.fit()
    got_losses = [l for h in tr.history for l in h["step_losses"]]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    got = dict(_leaves(params_to_jax(tr.model)))
    for path, value in _leaves(jax.tree.map(np.asarray, params)):
        noise = path.endswith("/key/bias")
        np.testing.assert_allclose(
            got[path], value, rtol=0,
            atol=3 * opt["learning_rate"] if noise else 2e-5,
            err_msg=f"{where} {path}")
