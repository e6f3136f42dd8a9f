"""The patch encoders against the JAX package
(``care_tpu/models/encoders.py:329-447``): ``CNN1`` / ``CNN2`` / ``CNN3``
(``CNNPatchEncoder``) and ``SingleStreamEmbedder`` inside the captioner,
the ``LightCNN`` and ``POSLayer`` blocks alone.

In the captioner (MSRVTT ``Transformer Base`` at the paper grid's test
size; the CNN encoders on 8 frames of 3 layers x 16 patches, the embedder
on the ``ami`` streams): the logits within 2e-4 absolute, token-identical
beams with scores within 1e-4, and after three train steps of the port's
``Trainer.fit`` and the JAX train step the parameters within 2e-5 absolute
(the attention key biases, whose true gradient is 0, within three steps of
the learning rate, as ``tests/test_torch_paper_grid_train.py`` holds them)
and the train-mode BatchNorm running statistics (flax's update: momentum
0.9, the biased batch variance) within 1e-6. ``LightCNN`` (flax's default
momentum 0.99) and ``POSLayer``: outputs in both modes within 1e-5 and the
statistics after one train-mode call within 1e-6. f32, dropout off.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.models import encoders as jax_encoders
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner, encoders
from care_tpu_torch.models.weights import (params_to_jax, variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.trainer import device_batch

from test_torch_backbone_card import ListLoader, two_threads  # noqa: F401
from test_torch_support import randomized, randomized_stats, to_numpy
from torch_paper_grid import tiny_opt

pytestmark = pytest.mark.usefixtures("two_threads")
ENCODERS = {"CNN1": "m", "CNN2": "m", "CNN3": "m",
            "SingleStreamEmbedder": "ami"}


def _opt(encoder):
    opt = tiny_opt({"dataset": "MSRVTT", "method": "Transformer",
                    "task": "Base", "feats": "ViT",
                    "modality": ENCODERS[encoder], "encoder": encoder})
    if encoder.startswith("CNN"):
        opt.update(n_frames=8, dim_m=16)
    return opt


def _batch(opt, batch_size, seed):
    """Token ids and labels, and the feature streams: for a CNN encoder
    the patch features [B, n_frames, 3 layers, n_patches]."""
    rs = np.random.RandomState(seed)
    shape = (batch_size, opt["max_len"] - 1)
    if opt["encoder"].startswith("CNN"):
        feats = [rs.randn(batch_size, opt["n_frames"], 3,
                          opt["dim_m"]).astype(np.float32)]
    else:
        feats = [rs.randn(batch_size, opt["n_frames"],
                          opt[f"dim_{c}"]).astype(np.float32)
                 for c in opt["modality"]]
    return {"feats": feats,
            "input_ids": rs.randint(6, opt["vocab_size"], shape).astype(
                np.int32),
            "labels": rs.randint(6, opt["vocab_size"], shape).astype(
                np.int32),
            "labels_attr": np.zeros((batch_size, opt[
                "attribute_prediction_k"]), np.float32)}


def _pair(opt, seed):
    jmodel = jax_build_captioner(opt)
    key = jax.random.PRNGKey(seed)
    variables = jmodel.init({"params": key, "dropout": key},
                            _batch(opt, 2, seed), deterministic=True)
    out = {"params": randomized(to_numpy(variables["params"]), seed + 1)}
    if "batch_stats" in variables:
        out["batch_stats"] = randomized_stats(variables["batch_stats"],
                                              seed + 2)
    port = build_captioner(opt, device="cpu", seed=seed)
    variables_from_jax(port, out)
    return jmodel, out, port


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("encoder", sorted(ENCODERS))
def test_captioner_with_patch_encoder_matches_jax(encoder, tmp_path,
                                                  monkeypatch):
    monkeypatch.chdir(tmp_path)
    opt = dict(_opt(encoder), epochs=1,
               checkpoint_path=str(tmp_path / "exps"))
    jmodel, variables, port = _pair(opt, seed=3)
    assert type(port.encoder).__name__ == type(
        jax_encoders.get_encoder(opt)).__name__

    batch = _batch(opt, 3, seed=4)
    want = jmodel.apply(variables, jax.tree.map(jnp.asarray, batch),
                        deterministic=True)["logits"]
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

    # three train steps: parameters and the running statistics
    batches = [_batch(opt, 4, seed=10 + i) for i in range(3)]
    jt = JaxTrainer(opt)
    jt.init_model(batches[0])
    jt.variables = jax.tree.map(jnp.asarray, variables)
    jt._build_tx(len(batches))
    step = jt._make_train_step()
    params, opt_state = jt.variables["params"], jt.opt_state
    extra = {k: v for k, v in jt.variables.items() if k != "params"}
    rng = jax.random.PRNGKey(1)
    for b in batches:
        rng, k = jax.random.split(rng)
        params, mutated, opt_state, _, _, _ = step(
            params, extra, opt_state, jax.tree.map(jnp.asarray, b), k, 0.0)
        extra = {**extra, **mutated}
    tr = Trainer(opt, ListLoader(batches), device="cpu")
    tr.init_model()
    variables_from_jax(tr.model, variables)
    tr.fit()
    got = dict(_leaves(params_to_jax(tr.model)))
    for path, value in _leaves(jax.tree.map(np.asarray, params)):
        noise = path.endswith("/key/bias")
        np.testing.assert_allclose(
            got[path], value, rtol=0,
            atol=3 * opt["learning_rate"] if noise else 2e-5,
            err_msg=f"{encoder} {path}")
    if encoder.startswith("CNN"):
        got_stats = dict(_leaves(variables_to_jax(tr.model)["batch_stats"]))
        start = dict(_leaves(variables["batch_stats"]))
        want_stats = dict(_leaves(jax.tree.map(np.asarray,
                                               extra["batch_stats"])))
        assert sorted(got_stats) == sorted(want_stats)
        for path, value in want_stats.items():
            np.testing.assert_allclose(got_stats[path], value, rtol=0,
                                       atol=1e-6, err_msg=path)
            assert np.abs(value - start[path]).max() > 1e-3, path


@pytest.mark.parametrize("block", ["LightCNN", "POSLayer"])
def test_block_matches_jax(block):
    rs = np.random.RandomState(5)
    g = torch.Generator().manual_seed(0)
    if block == "LightCNN":
        jmod = jax_encoders.LightCNN(chs=(3, 8, 16, 8), resolution=7)
        port = encoders.LightCNN(chs=(3, 8, 16, 8), resolution=7,
                                 generator=g)
        x = rs.randn(2, 4, 3 * 49).astype(np.float32)
    else:
        jmod = jax_encoders.POSLayer(resolution=3)
        port = encoders.POSLayer(resolution=3)
        x = rs.randn(2, 4, 5 * 9).astype(np.float32)
    variables = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    jvars = {"params": randomized(to_numpy(variables["params"]), 1)}
    if "batch_stats" in variables:
        jvars["batch_stats"] = randomized_stats(variables["batch_stats"], 2)
    variables_from_jax(port, jvars)
    for train in (False, True):
        kwargs = {"deterministic": not train} if block == "LightCNN" else {}
        if train and block == "LightCNN":
            want, mutated = jmod.apply(jvars, jnp.asarray(x),
                                       mutable=["batch_stats"], **kwargs)
        else:
            want = jmod.apply(jvars, jnp.asarray(x), **kwargs)
        with torch.no_grad():
            got = port.train(train)(torch.from_numpy(x)).numpy()
        assert got.shape == np.shape(want)
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    if block == "LightCNN":
        got_stats = dict(_leaves(variables_to_jax(port)["batch_stats"]))
        for path, value in _leaves(jax.tree.map(np.asarray,
                                                mutated["batch_stats"])):
            np.testing.assert_allclose(got_stats[path], value, rtol=0,
                                       atol=1e-6, err_msg=path)
