"""The captioner with an image backbone (``with_backbones``) against the
JAX package: the CARE flagship at test size with ``resnet18`` on 2 videos
of 4 frames of 32 x 32 here, and with CLIP ViT-B/32 at its published size
on 1 video of 2 frames of 224 x 224 in ``tests/test_torch_backbone_clip.py``
(``tests/test_torch_backbone_card.py`` holds the fixtures).

Held: the logits of the full forward within 2e-4 absolute (the JAX suite's
bound), token-identical beams with scores within 1e-4, and the parameters
after three train steps of the port's ``Trainer.fit`` and the JAX train
step within 2e-5 absolute, the attention key biases (whose true gradient
is 0, so that Adam turns rounding noise into steps of the learning rate)
within three steps, as ``tests/test_torch_paper_grid_train.py`` holds them.
The towers' kernels hold millions of elements, a few of which get a
gradient that cancels to rounding noise (about 1e-8 against a mean of
1e-2 in CLIP's ``conv1`` over one video's 98 patches); Adam steps those by
the learning rate in either direction (3 to 6 elements of a kernel of
300 000 to 600 000 here). So at most a 1e-4 share of a leaf may stray past
2e-5, and no element past three steps.
Also ``backbone_weights`` from a ``.pth`` the test writes, against
``care_tpu``'s ``maybe_load_backbone_weights``, and the assertions for the
names the registry refuses. f32, dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.models.backbone import \
    maybe_load_backbone_weights as jax_load_backbone_weights
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.cnn import (convert_cnn_state_dict, create_cnn,
                                       load_converted)
from care_tpu_torch.models.weights import params_to_jax, variables_from_jax
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.trainer import device_batch

from test_cnn import _randomize_bn_stats
from test_torch_backbone_card import (ListLoader, backbone_opt,  # noqa: F401
                                      frame_batch, two_threads)
from test_torch_support import randomized, randomized_stats, to_numpy
from torch_cnn_mirror import TorchResNet

pytestmark = pytest.mark.usefixtures("two_threads")
CASES = {"resnet18": dict(n_frames=4, batch=2),
         "clip~ViT-B/32": dict(n_frames=2, batch=1)}


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


def _pair(opt, seed):
    """(jax model, variables, port model): the captioner's parameters
    randomized as ``test_torch_support.flagship_pair`` does, the tower's
    at a hundredth of that noise (its kernels are lecun-small, and the
    flagship's 0.1 would swamp them), its frozen BatchNorm statistics
    randomized."""
    jmodel = jax_build_captioner(opt)
    batch = jax.tree.map(jnp.asarray, frame_batch(opt, 1, seed))
    key = jax.random.PRNGKey(seed)
    variables = jax.jit(lambda k, b: jmodel.init(
        {"params": k, "dropout": k}, b, deterministic=True))(key, batch)
    params = to_numpy(variables["params"])
    tower = params.pop("backbone")
    params = randomized(params, seed + 1)
    params["backbone"] = randomized(tower, seed + 3, scale=1e-3)
    out = {"params": params}
    if "batch_stats" in variables:
        out["batch_stats"] = randomized_stats(variables["batch_stats"],
                                              seed + 2)
    port = build_captioner(opt, device="cpu", seed=seed)
    variables_from_jax(port, out)
    return jmodel, out, port


def make_case(name):
    """(name, opt, jax model, variables, port model) of one backbone."""
    opt = backbone_opt(name, n_frames=CASES[name]["n_frames"])
    jmodel, variables, port = _pair(opt, seed=5)
    return name, opt, jmodel, variables, port


@pytest.fixture(scope="module")
def case():
    return make_case("resnet18")


def test_logits_and_beams_match_jax(case):
    check_logits_and_beams(case)


def test_three_train_steps_match_jax(case, tmp_path, monkeypatch):
    check_three_train_steps(case, tmp_path, monkeypatch)


def check_logits_and_beams(case):
    name, opt, jmodel, variables, port = case
    batch = frame_batch(opt, CASES[name]["batch"], seed=8)
    want = jax.jit(lambda v, b: jmodel.apply(v, b, deterministic=True)[
        "logits"])(variables, jax.tree.map(jnp.asarray, batch))
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)

    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": batch["feats"]})
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": batch["feats"]})
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


def check_three_train_steps(case, tmp_path, monkeypatch):
    name, opt, jmodel, variables, _ = case
    monkeypatch.chdir(tmp_path)
    opt = dict(opt, epochs=1, checkpoint_path=str(tmp_path / "exps"))
    batches = [frame_batch(opt, CASES[name]["batch"], seed=10 + i)
               for i in range(3)]

    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    params, opt_state, want_losses = jt.variables["params"], jt.opt_state, []
    extra = {k: v for k, v in jt.variables.items() if k != "params"}
    rng = jax.random.PRNGKey(1)
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
    got_losses = [l for h in tr.history for l in h["step_losses"]]
    np.testing.assert_allclose(got_losses, want_losses, rtol=1e-4)
    got = dict(_leaves(params_to_jax(tr.model)))
    lr = opt["learning_rate"]
    moved = 0.0
    for path, value in _leaves(jax.tree.map(np.asarray, params)):
        noise = path.endswith("/key/bias")
        gap = np.abs(got[path] - value)
        # Adam noise: an element whose gradient is rounding noise in both
        # packages (|g| ~1e-8 against a leaf's mean 1e-2: a sum over few
        # patches that cancels) takes steps of the learning rate in either
        # direction. At most a 1e-4 share of a leaf, within three steps.
        stray = gap > (3 * lr if noise else 2e-5)
        assert stray.mean() <= 1e-4 and gap.max() <= 3 * lr, \
            (name, path, int(stray.sum()), gap.size, float(gap.max()))
        if path.startswith("backbone/"):
            start = dict(_leaves(variables["params"]))[path]
            moved = max(moved, float(np.abs(value - start).max()))
    assert moved > 1e-4       # the tower trains end to end


def test_backbone_weights_load_as_jax(tmp_path):
    """``backbone_weights`` of a torchvision-named ResNet-18 ``.pth``: the
    trainer's model takes the converted weights after init, equal to
    ``care_tpu``'s loading of the same file, and its tower reproduces the
    standalone converted CNN."""
    torch.manual_seed(3)
    tm = _randomize_bn_stats(TorchResNet(depth=18).eval(), seed=3)
    path = str(tmp_path / "resnet18.pth")
    torch.save(tm.state_dict(), path)
    opt = backbone_opt("resnet18")
    opt["backbone_weights"] = ["" if c != "i" else path
                               for c in opt["modality"]]

    jmodel = jax_build_captioner(opt)
    key = jax.random.PRNGKey(0)
    batch = frame_batch(opt, 1, seed=1)
    jvars = jax_load_backbone_weights(
        jmodel.init({"params": key, "dropout": key}, batch), opt)
    tr = Trainer(opt, ListLoader([]), device="cpu")
    tr.init_model()
    tower = tr.model.backbone.Backbone_I
    want = {"params": jax.tree.map(np.asarray,
                                   jvars["params"]["backbone"]["Backbone_I"]),
            "batch_stats": jax.tree.map(
                np.asarray, jvars["batch_stats"]["backbone"]["Backbone_I"])}
    want["params"].pop("fc")         # flax keeps the head; it never runs
    check = create_cnn("resnet18", torch.Generator().manual_seed(9))
    variables_from_jax(check, want)
    for k, v in check.state_dict().items():
        assert torch.equal(tower.state_dict()[k], v), k

    standalone = load_converted(
        create_cnn("resnet18", torch.Generator().manual_seed(1)),
        convert_cnn_state_dict(tm.state_dict(), "resnet18")).eval()
    frames = torch.from_numpy(batch["feats"][2][0])
    with torch.no_grad():
        np.testing.assert_array_equal(tower.eval()(frames).numpy(),
                                      standalone(frames).numpy())


@pytest.mark.parametrize("names,message", [
    (["", "", "vgg19", ""], "unsupported backbone"),
    (["", "", "clip~ViT-L/14", ""], "unsupported CLIP arch"),
    (["resnet18", "", "", ""], "only the image backbone"),
    (["", "resnet18"], None)])
def test_refused_backbones_raise(names, message):
    """The registry's assertions, as ``care_tpu``'s: an unknown CNN or
    CLIP arch, a backbone on a stream other than ``i``, and a list whose
    length is not the modality's."""
    opt = dict(backbone_opt("resnet18"), with_backbones=names)
    with pytest.raises(AssertionError, match=message):
        build_captioner(opt, device="cpu")
    jmodel = jax_build_captioner(opt)
    key = jax.random.PRNGKey(0)
    with pytest.raises(AssertionError):
        jmodel.init({"params": key, "dropout": key},
                    frame_batch(backbone_opt("resnet18"), 1, seed=1))


@pytest.mark.parametrize("dtype", [None, "bfloat16"])
def test_translator_carries_frames_once_per_batch(dtype):
    """The translator's feature copy keeps the raw-frame stream 5-D, in the
    serving dtype (bf16 serving casts it, as ``care_tpu`` casts its float
    streams), and the tower runs once per batch on its B x F frames, not on
    the beam-enlarged rows."""
    opt = dict(backbone_opt("resnet18", n_frames=2),
               compute_dtype_decode=dtype)
    feats = frame_batch(opt, 3, seed=2)["feats"]
    translator = get_translator(opt, device="cpu")
    on_device = translator._feats({"feats": feats})
    want = torch.bfloat16 if dtype else torch.float32
    assert on_device[2].shape == (3, 2, 32, 32, 3)
    assert all(t.dtype == want for t in on_device)
    model = build_captioner(opt, device="cpu", seed=1)
    seen = []
    served = translator.serving_model(model)
    hook = served.backbone.Backbone_I.register_forward_hook(
        lambda m, args, out: seen.append((tuple(args[0].shape),
                                          args[0].dtype)))
    try:
        hyps, scores = translator.translate_batch(model, {"feats": feats})
    finally:
        hook.remove()
    assert seen == [((6, 32, 32, 3), want)]
    assert len(hyps) == 3 and np.isfinite(scores).all()
