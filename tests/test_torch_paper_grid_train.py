"""One command of each model family of the paper grid trains three steps
in both packages (``tests/torch_paper_grid.py``): the plain baseline, CARE
(G1Lc), the concept-attention sublayer (CABase, and the ``parallel``
placement), semantic composition, and ARB's HighWay / BatchNorm encoder.

The port's ``Trainer.fit`` runs one epoch of three batches from the same
weights as the JAX package's jitted train step: per-step losses within
1e-4 relative and the parameters after the three updates within 2e-5
absolute, as ``tests/test_torch_trainer.py`` holds the flagship; the first
step's gradients within 1e-3 relative + 1e-6 absolute; the BatchNorm
running statistics after the three steps within 1e-6. f32, dropout off.

The attention key biases are the exception to the 2e-5: a bias on the keys
shifts every score of a query row by the same amount, so their true
gradient is zero and both packages' gradients are rounding noise, which
Adam scales up to steps of the learning rate. They are held to three such
steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.models.weights import (grads_to_jax, params_to_jax,
                                           variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import COMMANDS, family, tiny_opt

FAMILIES = ["MSRVTT-Base-ViT-ami", "MSRVTT-CARE-ViT-VA-VAT",
            "MSRVTT-CABase-ViT-VA", "GLSG-G1L1-parallel",
            "GLSG-G0Lc-SC-bias", "ARB-CARE-MSRVTT"]
BY_ID = {c[0]: c for c in COMMANDS}


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


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


def _jax_batch(batch):
    return jax.tree.map(jnp.asarray, batch)


def test_families_are_covered():
    assert sorted({family(tiny_opt(c[2])) for c in COMMANDS}) == sorted(
        {family(tiny_opt(BY_ID[i][2])) for i in FAMILIES})


@pytest.mark.parametrize("command", FAMILIES)
def test_family_trains_as_jax(command, tmp_path):
    _, where, overrides = BY_ID[command]
    opt = dict(tiny_opt(overrides), epochs=1,
               checkpoint_path=str(tmp_path / "exps"))
    jmodel, variables, _ = flagship_pair(opt, seed=5)
    batches = [synthetic_batch(opt, 4, seed=10 + i) for i in range(3)]
    extra = {k: v for k, v in variables.items() if k != "params"}

    # the JAX package: the first step's gradients, then three steps
    crit = JaxCriterion(opt)
    rngs = {"dropout": jax.random.PRNGKey(0)}

    def loss_fn(p):
        jb = _jax_batch(batches[0])
        outputs, _ = jmodel.apply(
            {"params": p, **extra}, jb, deterministic=False,
            mutable=["batch_stats"], rngs=rngs)

        def project_fn(feats, flag):
            return jmodel.apply({"params": p, **extra}, feats, flag,
                                method=type(jmodel).project_attribute)
        return crit({**outputs, **jb}, project_fn)[0]

    want_loss0, want_grads = jax.value_and_grad(loss_fn)(
        variables["params"])
    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    params, opt_state, want_losses = jt.variables["params"], jt.opt_state, []
    extra_vars = {k: v for k, v in jt.variables.items() if k != "params"}
    rng = jax.random.PRNGKey(1)
    for b in batches:
        rng, k = jax.random.split(rng)
        params, mutated, opt_state, loss, _, _ = step(
            params, extra_vars, opt_state, _jax_batch(b), k, 0.0)
        extra_vars = {**extra_vars, **mutated}
        want_losses.append(float(loss))
    np.testing.assert_allclose(want_losses[0], float(want_loss0), rtol=1e-5)

    # the port: the first step's gradients on a fresh copy, then fit
    tr = Trainer(opt, ListLoader(batches), device="cpu")
    tr.init_model()
    variables_from_jax(tr.model, variables)
    model = tr.model
    tb = device_batch(batches[0], "cpu")
    total, _, _ = Criterion(opt)({**model(tb), **tb},
                                 model.project_attribute)
    total.backward()
    np.testing.assert_allclose(total.item(), float(want_loss0), rtol=2e-5)
    got = dict(_leaves(grads_to_jax(model)))
    want = dict(_leaves(jax.tree.map(np.asarray, want_grads)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-3,
                                   atol=1e-6, err_msg=f"{where} {path}")
    model.zero_grad()
    variables_from_jax(model, variables)      # undo the BatchNorm update

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
    if family(opt) == "ARB":
        got_stats = dict(_leaves(variables_to_jax(tr.model)["batch_stats"]))
        want_stats = dict(_leaves(jax.tree.map(
            np.asarray, extra_vars["batch_stats"])))
        start = dict(_leaves(variables["batch_stats"]))
        assert sorted(got_stats) == sorted(want_stats)
        for path, value in want_stats.items():
            np.testing.assert_allclose(got_stats[path], value, rtol=0,
                                       atol=1e-6, err_msg=path)
            assert np.abs(value - start[path]).max() > 1e-3, path
