"""The port's optimizer recipe (``care_tpu_torch.training.optim``) against the
JAX package's optax chains on the same parameters and gradients: Adam steps
with the global-norm clip and filtered weight decay, a frozen subset, the
dual-Adam recipe after the low-LR switch, and the LR schedules on a grid of
steps. f32 on both sides; parameter *updates* are compared at 1e-3 relative
+ 1.5e-7 absolute (an update of ~5e-4 on a LayerNorm scale of ~1 resolves to
one f32 ulp, 1.2e-7), schedules at 1e-6 relative + 1e-10 absolute (optax
evaluates them in f32, where ``1 - step / total`` near the end cancels to
an absolute error of about lr * 1.2e-7)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from care_tpu.training import optim as jax_optim
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.weights import jax_leaf_key, params_to_jax
from care_tpu_torch.training import optim
from test_torch_support import flagship_small_opt


def _model_and_grads(opt, seed, scale):
    model = build_captioner(opt, device="cpu", seed=seed)
    params = params_to_jax(model)
    rs = np.random.RandomState(seed)
    steps = [jax.tree.map(lambda x: (scale * rs.randn(*x.shape)
                                     ).astype(np.float32), params)
             for _ in range(2)]
    return model, params, steps


def _set_grads(model, grads):
    for name, p in model.named_parameters():
        key, transpose = jax_leaf_key(model, name)
        g = grads
        for part in key:
            g = g[part]
        p.grad = torch.tensor(np.ascontiguousarray(g.T) if transpose else g)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _assert_same_trajectory(model, tx, jtx, params, grad_steps):
    state = jtx.init(params)
    for grads in grad_steps:
        updates, state = jtx.update(grads, state, params)
        new = jax.tree.map(lambda p, u: np.asarray(p + u), params, updates)
        _set_grads(model, grads)
        tx.step()
        got = dict(_leaves(params_to_jax(model)))
        old = dict(_leaves(params))
        moved = 0
        for path, want in _leaves(new):
            np.testing.assert_allclose(got[path] - old[path],
                                       want - old[path], rtol=1e-3,
                                       atol=1.5e-7, err_msg=path)
            moved += bool(np.any(want != old[path]))
        assert moved > len(old) // 2
        params = new


RECIPES = {
    "plain": {},
    "clip": {"gradient_clip_val": 0.5},
    "filtered_decay": {"gradient_clip_val": 0.5, "filter_weight_decay": True,
                       "filter_biases": True,
                       "skip_substr_list": ["word_embeddings"]},
    "no_decay": {"weight_decay": 0.0},
    "frozen": {"freeze_parameters_except": ["decoder", "cls_head"],
               "gradient_clip_val": 0.5},
}


@pytest.mark.parametrize("recipe", sorted(RECIPES))
def test_adam_steps_match_optax(recipe):
    opt = dict(flagship_small_opt(), **RECIPES[recipe])
    model, params, grad_steps = _model_and_grads(opt, 3, 0.05)
    # 4 steps per epoch: the second step already sits in the next LR epoch
    # of a schedule offset by 3
    sched = jax_optim.make_lr_schedule(opt, 4)
    jtx = jax_optim.make_adam(opt, lambda s: sched(s + 3), params)
    psched = optim.make_lr_schedule(opt, 4)
    tx = optim.make_adam(opt, lambda s: psched(s + 3), model)
    _assert_same_trajectory(model, tx, jtx, params, grad_steps)


@pytest.mark.parametrize("clip", [0.0, 0.5])
def test_dual_adam_after_the_switch_matches_optax(clip):
    opt = dict(flagship_small_opt(), gradient_clip_val=clip,
               filter_weight_decay=True, filter_biases=True)
    model, params, grad_steps = _model_and_grads(opt, 4, 0.05)
    jtx = jax_optim.make_dual_adam(opt, params, 4, offset_steps=7)
    tx = optim.make_dual_adam(opt, model, 4, offset_steps=7)
    # the low group is the encoder and the concept detector, at the low LR
    labels = optim.lowlr_param_labels(model, opt)
    jlabels = dict(_leaves(jax_optim.lowlr_param_labels(params, opt)))
    paths = optim.param_paths(model)
    assert {paths[n]: lab for n, lab in labels.items()} == {
        k: str(v) for k, v in jlabels.items()}
    assert set(labels.values()) == {"low", "normal"}
    decay = opt["lr_decay"]
    np.testing.assert_allclose(
        tx.learning_rates(),
        [opt["low_learning_rate"] * decay, opt["learning_rate"] * decay])
    _assert_same_trajectory(model, tx, jtx, params, grad_steps)


def test_masks_match_jax():
    opt = dict(flagship_small_opt(), filter_biases=True,
               skip_substr_list=["LayerNorm", "hybrid"],
               freeze_parameters_except=["inter_attention"])
    model = build_captioner(opt, device="cpu")
    params = params_to_jax(model)
    paths = optim.param_paths(model)
    for got, want in (
            (optim._decay_mask(model, True, opt["skip_substr_list"]),
             jax_optim._decay_mask(params, True, opt["skip_substr_list"])),
            (optim.freeze_mask(model, opt),
             jax_optim.freeze_mask(params, opt))):
        want = {k: bool(v) for k, v in _leaves(want)}
        assert {paths[n]: v for n, v in got.items()} == want
        assert len(set(want.values())) == 2
    assert optim.freeze_mask(model, flagship_small_opt()) is None


SCHEDULES = {
    "linear": {"lr_scheduler_type": "linear", "lr_decay": 0.9},
    "linear_step3": {"lr_scheduler_type": "linear", "lr_step_size": 3},
    "cosine": {"lr_scheduler_type": "cosine", "epochs": 10},
    "warmup_ratio": {"lr_scheduler_type": "linear_with_warmup", "epochs": 10,
                     "learning_rate_warmup_ratio": 0.1},
    "warmup_steps": {"lr_scheduler_type": "linear_with_warmup",
                     "max_steps": 120, "learning_rate_warmup_steps": 20},
    "constant": {"lr_scheduler_type": "none"},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_jax_on_a_grid(name):
    opt = dict(flagship_small_opt(), **SCHEDULES[name])
    for base_lr in (None, 5e-5):
        want = jax_optim.make_lr_schedule(opt, 10, base_lr)
        got = optim.make_lr_schedule(opt, 10, base_lr)
        for step in (0, 1, 5, 9, 10, 11, 19, 20, 21, 50, 99, 100, 119, 150):
            np.testing.assert_allclose(got(step),
                                       float(want(jnp.asarray(step))),
                                       rtol=1e-6, atol=1e-10,
                                       err_msg=f"{name} step {step}")


def test_plateau_schedule_is_the_jax_constant():
    """Under ``plateau`` the schedule is the constant base LR; the trainer
    scales it after validation (``PlateauController``)."""
    opt = dict(flagship_small_opt(), lr_scheduler_type="plateau")
    want = jax_optim.make_lr_schedule(opt, 10)
    got = optim.make_lr_schedule(opt, 10)
    for step in (0, 9, 10, 99):
        assert got(step) == float(want(step)) == opt["learning_rate"]


def test_clip_is_the_optax_rule():
    """Below the threshold the gradients pass unchanged, bit for bit; above
    it their global norm becomes the threshold."""
    opt = dict(flagship_small_opt(), gradient_clip_val=1.0, weight_decay=0.0)
    model = build_captioner(opt, device="cpu")
    tx = optim.make_adam(opt, lambda s: 0.0, model)
    for scale, clipped in ((1e-4, False), (1.0, True)):
        gen = torch.Generator().manual_seed(0)
        before = {}
        for name, p in model.named_parameters():
            p.grad = scale * torch.randn(p.shape, generator=gen)
            before[name] = p.grad.clone()
        tx.step()
        after = {n: p.grad for n, p in model.named_parameters()}
        norm = torch.sqrt(sum((g ** 2).sum() for g in after.values())).item()
        if clipped:
            np.testing.assert_allclose(norm, 1.0, rtol=1e-5)
        else:
            assert all(torch.equal(after[n], before[n]) for n in before)
