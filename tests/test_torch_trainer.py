"""The training slice of the port as a whole against the JAX package: the same
weights (``params_from_jax``) and the same batches through both stacks.

* first step: total loss and every gradient leaf (``grads_to_jax``) against
  ``jax.value_and_grad`` of the ``care_tpu`` loss;
* ``Trainer.fit`` over two epochs of two steps, with the dual-Adam switch at
  epoch 1: per-step losses and the final parameters against the ``care_tpu``
  jitted train step driven the same way;
* fused against dense cross-entropy inside the port, the ``auto`` policy,
  repeatability from a seed with dropout on, and the rejected options.

f32 and dropout 0 on both sides unless a test says otherwise (the two
frameworks' random streams differ). On the CPU the port's fused path runs
the plain versions of its kernels. Tolerances are stated where used.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.models.common import Dropout
from care_tpu_torch.models.weights import (grads_to_jax, params_from_jax,
                                           params_to_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.training.trainer import device_batch
from test_torch_support import flagship_small_opt, randomized, to_numpy

NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


@pytest.fixture(autouse=True)
def _in_tmp_path(tmp_path, monkeypatch):
    """``fit`` keeps checkpoints under the relative ``checkpoint_path`` of
    the options: run each test in its own directory."""
    monkeypatch.chdir(tmp_path)


class ListLoader:
    """The loader contract of ``Trainer``: ``__iter__``, ``__len__``,
    ``set_epoch``; the same numpy batches every epoch."""

    def __init__(self, batches):
        self.batches = batches
        self.epochs_seen = []

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        self.epochs_seen.append(epoch)


def _opt(tmp_path=None, **extra):
    opt = dict(flagship_small_opt(), **NO_DROPOUT, **extra)
    if tmp_path is not None:
        opt["checkpoint_path"] = str(tmp_path / "exps")
    return opt


def _numpy_batches(opt, n, batch_size=4, seed=0):
    out = []
    for i in range(n):
        b = graft._synthetic_batch(opt, batch_size, seed=seed + i)
        out.append({"feats": [np.array(f) for f in b["feats"]],
                    "input_ids": np.array(b["input_ids"]),
                    "labels": np.array(b["labels"]),
                    "labels_attr": np.array(b["labels_attr"])})
    return out


def _jax_batch(batch):
    return {"feats": [jnp.asarray(f) for f in batch["feats"]],
            "input_ids": jnp.asarray(batch["input_ids"]),
            "labels": jnp.asarray(batch["labels"]),
            "labels_attr": jnp.asarray(batch["labels_attr"])}


def _jax_params(opt, batch, seed=0):
    jmodel = jax_build_captioner(opt)
    key = jax.random.PRNGKey(seed)
    variables = jmodel.init({"params": key, "dropout": key},
                            _jax_batch(batch), deterministic=True)
    return jmodel, randomized(to_numpy(variables["params"]), seed + 1)


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _port_trainer(opt, batches, params=None):
    tr = Trainer(opt, ListLoader(batches), device="cpu")
    tr.init_model()
    if params is not None:
        params_from_jax(tr.model, params)
    return tr


def _step_losses(tr):
    return [l for h in tr.history for l in h["step_losses"]]


# ---------------------------------------------------------------------------
# first step: loss and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fused", [False, True])
def test_first_step_loss_and_gradients_match_jax(fused):
    opt = _opt(label_smoothing=0.1, fused_xent_chunk=32)
    batch = _numpy_batches(opt, 1)[0]
    jmodel, params = _jax_params(opt, batch)
    jcrit = JaxCriterion(opt)

    def loss_fn(p):
        jb = _jax_batch(batch)
        outputs = jmodel.apply({"params": p}, jb, deterministic=True,
                               collect_aux=False)
        return jcrit({**outputs, **jb})[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(params)

    tr = _port_trainer(opt, [batch], params)
    model = tr.model
    tb = device_batch(batch, "cpu")
    outputs = model(tb, compute_logits=not fused)
    assert ("logits" in outputs) != fused
    results = {**outputs, **tb}
    if fused:
        results["cls_head_kernel"] = model.cls_head.tgt_word_prj.weight
    total, _, _ = Criterion(opt)(results)
    total.backward()

    # loss: 2e-5 relative, the Criterion tests' bound. Gradients: 1e-3
    # relative + 1e-6 absolute; sums run in other orders in XLA and torch,
    # and leaves range over several orders of magnitude
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=2e-5)
    got = dict(_leaves(grads_to_jax(model)))
    want = dict(_leaves(to_numpy(want_grads)))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-3,
                                   atol=1e-6, err_msg=path)
        assert np.any(want[path] != 0), path


# ---------------------------------------------------------------------------
# fit: losses and parameters follow the JAX train step
# ---------------------------------------------------------------------------

def test_fit_follows_the_jax_train_step_through_the_switch(tmp_path):
    opt = _opt(tmp_path, epochs=2, lowlr_start_epoch=1, fused_xent=False,
               gradient_clip_val=5.0)
    assert opt["wrapper"] == "MultipleOptimizerModel"
    batches = _numpy_batches(opt, 2)
    _, params = _jax_params(opt, batches[0])

    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = {"params": jax.tree.map(jnp.asarray, params)}
    jt._build_tx(len(batches))
    want_losses = []
    rng = jax.random.PRNGKey(1)
    for epoch in range(2):
        jt._maybe_switch_optimizer(epoch)
        if jt._train_step_fn is None:
            jt._train_step_fn = jt._make_train_step()
        for b in batches:
            rng, k = jax.random.split(rng)
            p, _, jt.opt_state, loss, _, _ = jt._train_step_fn(
                jt.variables["params"], {}, jt.opt_state, _jax_batch(b), k,
                0.0)
            jt.variables = {"params": p}
            jt.global_step += 1
            want_losses.append(float(loss))
    assert jt._switched

    tr = _port_trainer(opt, batches, params)
    tr.fit()
    assert tr._switched and tr._switch_offset == 2 and tr.global_step == 4
    assert tr.train_loader.epochs_seen == [0, 1]
    assert [h["n_steps"] for h in tr.history] == [2, 2]
    # 1e-4 relative on the losses of steps that follow 0-3 updates; 2e-5
    # absolute on parameters that moved by about 4 * 5e-4
    np.testing.assert_allclose(_step_losses(tr), want_losses, rtol=1e-4)
    got = dict(_leaves(params_to_jax(tr.model)))
    start = dict(_leaves(params))
    for path, want in _leaves(to_numpy(jt.variables["params"])):
        np.testing.assert_allclose(got[path], want, rtol=0, atol=2e-5,
                                   err_msg=path)
        assert np.abs(want - start[path]).max() > 1e-4, path
    log = tr.history[-1]
    assert {"train_loss", "Lang Loss", "V-Attr", "Word Acc0", "Perplexity",
            "epoch_time", "schedule_sampling_prob"} <= set(log)
    np.testing.assert_allclose(log["train_loss"], np.mean(want_losses[2:]),
                               rtol=1e-4)


def test_fused_follows_dense_in_the_port():
    """Step 0 is the same function of the same weights (1e-6 relative);
    the next steps stay within 1e-3 absolute, the bound the JAX package's
    own fused-against-dense test uses."""
    losses = {}
    for fused in (False, True):
        opt = _opt(epochs=1, fused_xent=fused, fused_xent_chunk=32)
        tr = _port_trainer(opt, _numpy_batches(opt, 3))
        tr.fit()
        assert tr._fused_xent is fused
        losses[fused] = _step_losses(tr)
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-6)
    np.testing.assert_allclose(losses[True], losses[False], rtol=0, atol=1e-3)


def test_fused_xent_backend_auto_trains():
    """``fused_xent_backend: auto``, the one value the trainer takes, trains
    through the fused cross-entropy."""
    opt = _opt(epochs=1, fused_xent=True, fused_xent_chunk=32,
               fused_xent_backend="auto")
    tr = _port_trainer(opt, _numpy_batches(opt, 2))
    tr.fit()
    assert tr._fused_xent is True
    losses = _step_losses(tr)
    assert len(losses) == 2 and np.all(np.isfinite(losses))


def test_fused_xent_auto_threshold():
    def gate(**extra):
        opt = _opt(**extra)
        tr = _port_trainer(opt, _numpy_batches(opt, 1))
        tr._build_tx(1)
        tr._make_train_step()
        return tr._fused_xent

    assert gate(fused_xent="auto") is False
    assert gate(fused_xent="auto", fused_xent_auto_threshold_mb=0) is True
    assert gate(fused_xent=True) is True
    assert gate(fused_xent=False, fused_xent_auto_threshold_mb=0) is False
    # the flagship's own numbers: 171.9 MB at batch 64, 515.6 MB at 192
    wide = dict(max_len=30, vocab_size=11000, fused_xent="auto")
    assert gate(batch_size=64, **wide) is False
    assert gate(batch_size=192, **wide) is True
    # eligibility: the head must be the plain one
    assert gate(fused_xent=True, crits=["attribute"]) is False


# ---------------------------------------------------------------------------
# dropout and repeatability
# ---------------------------------------------------------------------------

def _dropout_opt(**extra):
    return dict(flagship_small_opt(), epochs=1, **extra)


def test_two_fits_from_one_seed_repeat_with_dropout_on():
    runs = []
    for seed in (0, 0, 1):
        opt = _dropout_opt(seed=seed, fused_xent=True, fused_xent_chunk=32)
        assert opt["hidden_dropout_prob"] > 0
        assert opt["attention_probs_dropout_prob"] > 0
        tr = Trainer(opt, ListLoader(_numpy_batches(opt, 3)), device="cpu")
        tr.fit()
        assert tr.model.training
        runs.append(_step_losses(tr))
    assert runs[0] == runs[1]
    assert runs[0] != runs[2]
    assert all(np.isfinite(runs[0]))


def test_dropout_runs_only_in_training_mode_and_reaches_attention():
    opt = _dropout_opt()
    tr = _port_trainer(opt, [])
    model = tr.model
    drops = {n: m for n, m in model.named_modules() if isinstance(m, Dropout)}
    attn = [n for n in drops if n.endswith("attn_dropout")]
    assert len(attn) == 2 and all(
        drops[n].p == opt["attention_probs_dropout_prob"] for n in attn)
    assert all(m.generator is tr.dropout_generator for m in drops.values())
    batch = device_batch(_numpy_batches(opt, 1)[0], "cpu")
    with torch.no_grad():
        a = model(batch)["logits"]
        b = model(batch)["logits"]
        assert not torch.equal(a, b)
        # only the attention-probability dropout left on
        for n, m in drops.items():
            m.p = opt["attention_probs_dropout_prob"] if n in attn else 0.0
        c = model(batch)["logits"]
        d = model(batch)["logits"]
        assert not torch.equal(c, d)
        model.eval()
        assert torch.equal(model(batch)["logits"], model(batch)["logits"])


def test_dropout_keeps_the_mean():
    drop = Dropout(0.25).train()
    drop.generator = torch.Generator().manual_seed(0)
    x = torch.ones(200, 200)
    y = drop(x)
    assert set(y.unique().tolist()) == {0.0, float(np.float32(1.0 / 0.75))}
    np.testing.assert_allclose(y.mean().item(), 1.0, atol=0.01)
    assert drop.eval()(x) is x


# ---------------------------------------------------------------------------
# what this slice rejects
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key,value", [
    ("fused_xent_backend", "xla"), ("fused_xent_backend", "pallas")])
def test_rejected_options_raise_naming_themselves(key, value):
    opt = _opt(**{key: value})
    with pytest.raises(NotImplementedError, match=key):
        Trainer(opt, ListLoader([]), device="cpu")


@pytest.mark.parametrize("key,value", [("backbone_weights", "resnet.pth")])
def test_backbone_weights_are_accepted(key, value):
    """``backbone_weights`` used to raise. Without ``with_backbones`` it
    names no tower and the model builds as without it, as in the JAX
    package (``tests/test_torch_backbone.py`` loads a ``.pth`` into a
    backbone)."""
    tr = Trainer(_opt(**{key: value}), ListLoader([]), device="cpu")
    assert tr.init_model().backbone is None


@pytest.mark.parametrize("key,value", [
    ("teacher_path", "teacher.ckpt"), ("with_teacher_during_training", True)])
def test_teacher_options_are_accepted(key, value):
    """The teacher options used to raise. An AR model takes no teacher, as
    in the JAX package: the path is not even opened
    (``tests/test_torch_nar_train.py`` trains and validates a NAR student
    with one)."""
    tr = Trainer(_opt(**{key: value}), ListLoader([]), device="cpu")
    assert tr._get_teacher() == (None, None)
    assert tr._teacher_kwargs() == {}


@pytest.mark.parametrize("name", ["mesh"])
def test_rejected_arguments_raise_naming_themselves(name):
    """A mesh is taken since the parallel slice; what is not a
    ``care_tpu_torch.parallel.Mesh`` is refused by name."""
    with pytest.raises(TypeError, match=name):
        Trainer(_opt(), ListLoader([]), device="cpu", **{name: object()})


def test_trainer_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer(_opt(), ListLoader([]))
    tr = Trainer(_opt(), ListLoader([]), device="cpu")
    with pytest.raises(ValueError, match="train_loader"):
        Trainer(_opt(), device="cpu").fit()
    assert tr.device.type == "cpu"


def test_weights_round_trip_and_refuse_unnamed_parameters():
    opt = _opt()
    batch = _numpy_batches(opt, 1)[0]
    _, params = _jax_params(opt, batch)
    tr = _port_trainer(opt, [batch], params)
    back = dict(_leaves(params_to_jax(tr.model)))
    for path, want in _leaves(params):
        np.testing.assert_array_equal(back[path], want)
    with pytest.raises(ValueError, match="no gradient"):
        grads_to_jax(tr.model)
    tr.model.stray = torch.nn.Parameter(torch.zeros(1))
    with pytest.raises(KeyError, match="stray"):
        params_to_jax(tr.model)
