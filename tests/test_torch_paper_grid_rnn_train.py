"""The RNN captioners of the paper grid (``torch_paper_grid.RNN_COMMANDS``)
train two steps in both packages from the same weights: the port's
``Trainer.fit`` against the JAX package's jitted train step, losses within
1e-4 relative, parameters within 2e-5 and, for VOE, the BatchNorm running
statistics within 1e-6. The presets start scheduled sampling at epoch 0,
where its probability is 0 in both packages
(``tests/test_torch_rnn_train.py`` holds the sampling itself). f32,
dropout and the concept detector's sparse frame sampling off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.models.weights import (params_to_jax, variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training import Trainer

from test_torch_paper_grid_train import ListLoader, _leaves
from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import RNN_COMMANDS, case_ids, tiny_opt


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)


@pytest.mark.parametrize("overrides", [c[2] for c in RNN_COMMANDS],
                         ids=case_ids(RNN_COMMANDS))
def test_rnn_command_trains_as_jax(overrides, tmp_path):
    # the concept detector's sparse frame sampling (DAP_RNN's VAP part)
    # draws in training, from generators the two packages do not share
    opt = dict(tiny_opt(overrides), epochs=1,
               attribute_prediction_sparse_sampling=False,
               checkpoint_path=str(tmp_path / "exps"))
    assert opt["scheduled_sampling_start"] == 0
    jmodel, variables, _ = flagship_pair(opt, seed=5)
    batches = [synthetic_batch(opt, 4, seed=10 + i) for i in range(2)]

    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    params, opt_state = jt.variables["params"], jt.opt_state
    extra = {k: v for k, v in jt.variables.items() if k != "params"}
    rng, want_losses = jax.random.PRNGKey(1), []
    for b in batches:
        rng, k = jax.random.split(rng)
        params, mutated, opt_state, loss, _, _ = step(
            params, extra, opt_state, jax.tree.map(jnp.asarray, b), k, 0.0)
        extra = {**extra, **mutated}
        want_losses.append(float(loss))

    tr = Trainer(opt, ListLoader(batches), device="cpu")
    tr.init_model()
    variables_from_jax(tr.model, variables)
    tr.fit()
    assert not tr._fused_xent
    got_losses = [l for h in tr.history for l in h["step_losses"]]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    got = dict(_leaves(params_to_jax(tr.model)))
    want = dict(_leaves(jax.tree.map(np.asarray, params)))
    assert sorted(got) == sorted(want)
    for path, value in want.items():
        np.testing.assert_allclose(got[path], value, rtol=0, atol=2e-5,
                                   err_msg=path)
    if "batch_stats" in variables:
        got_stats = dict(_leaves(variables_to_jax(tr.model)["batch_stats"]))
        want_stats = dict(_leaves(jax.tree.map(np.asarray,
                                               extra["batch_stats"])))
        assert sorted(got_stats) == sorted(want_stats)
        for path, value in want_stats.items():
            np.testing.assert_allclose(got_stats[path], value, rtol=0,
                                       atol=1e-6, err_msg=path)
