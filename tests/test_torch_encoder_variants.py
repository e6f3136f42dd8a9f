"""The encoder's other stream kinds and fusions against the JAX package,
and ARB's BatchNorm.

* every ``encoder`` kind (``Embedder``, ``ReLUEmbedder``, ``Identity``,
  ``EncoderWithHighWayBN``, ``MultiTransformerEncoder``,
  ``TransformerEncoder``), with the component views of a CARE model for
  the Transformer kinds: encoder outputs and logits within 2e-4, beams
  token-identical;
* the fusions ``addition``, ``channel_concat`` (the cross attention's
  keys of width D * streams) and ``none`` (one stream);
* BatchNorm: the running statistics after three training forwards equal
  the JAX package's ``batch_stats`` within 1e-6 and move; evaluation then
  uses them (logits within 2e-4); ``variables_to_jax`` /
  ``variables_from_jax`` carry them, unused or missing leaves raise;
  ``Trainer.fit`` moves them, and a resumed ARB run equals the
  uninterrupted one bit for bit.

Test size, f32, dropout off unless a test says otherwise.
"""

import jax
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.weights import (variables_from_jax,
                                           variables_to_jax)
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.checkpoints import (load_checkpoint,
                                                 save_checkpoint)
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import tiny_opt

BASE = dict(dataset="MSRVTT", arch="base", method="Transformer",
            task="Base", feats="ViT", modality="mi")
CARE = dict(dataset="MSRVTT", arch="base", method="Transformer",
            task="CARE", feats="ViT", decoder_modality_flags="V",
            predictor_modality_flags="VAT")


def _check(opt, seed, batch_size=3):
    jmodel, variables, port = flagship_pair(opt, seed=seed)
    batch = synthetic_batch(opt, batch_size, seed=seed + 1)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    enc = want["encoder_hidden_states"]
    if isinstance(enc, (list, tuple)):
        enc = enc[0]
        assert len(got["encoder_hidden_states"]) == 1
        got_enc = got["encoder_hidden_states"][0]
    else:
        got_enc = got["encoder_hidden_states"]
    np.testing.assert_allclose(got_enc.numpy(), np.asarray(enc), rtol=0,
                               atol=2e-4)
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), rtol=0, atol=2e-4)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": batch["feats"]})
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": batch["feats"]})
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    return jmodel, variables, port, want, got


@pytest.mark.parametrize("encoder", [
    "Embedder", "ReLUEmbedder", "Identity", "EncoderWithHighWayBN",
    "MultiTransformerEncoder", "TransformerEncoder"])
def test_stream_kind_matches_jax(encoder):
    opt = tiny_opt(dict(BASE, final_overrides={"encoder": encoder}))
    if encoder == "Identity":       # the streams keep their widths
        opt["dim_m"] = opt["dim_i"] = opt["dim_hidden"]
    *_, want, got = _check(opt, seed=1)
    if encoder == "TransformerEncoder":
        assert len(got["all_encoder_hidden_states"]) == 2
        np.testing.assert_allclose(
            got["all_encoder_intra_attentions"][0].numpy(),
            np.asarray(want["all_encoder_intra_attentions"][0]), rtol=0,
            atol=2e-4)


@pytest.mark.parametrize("encoder", ["MultiTransformerEncoder",
                                     "TransformerEncoder"])
def test_transformer_kinds_with_component_views(encoder):
    """CARE with the decoder on ``mi`` and the detector on ``amir``: the
    shared Transformer encoder runs again over each view's streams."""
    opt = tiny_opt(dict(CARE, final_overrides={"encoder": encoder}))
    assert opt["modality_for_decoder"] != opt["modality"]
    _check(opt, seed=2)


@pytest.mark.parametrize("fusion,modality", [
    ("addition", "mi"), ("channel_concat", "mi"), ("none", "i")])
def test_fusion_matches_jax(fusion, modality):
    opt = tiny_opt(dict(BASE, modality=modality,
                        final_overrides={"fusion": fusion}))
    jmodel, variables, port, _, _ = _check(opt, seed=3)
    if fusion == "channel_concat":
        assert port.decoder.layer_0.inter_attention.key.in_features == (
            2 * opt["dim_hidden"])


def _arb_opt(**extra):
    return tiny_opt(dict(BASE, method="ARB", modality="ami",
                         final_overrides=extra))


def test_batch_norm_running_stats_follow_jax():
    opt = _arb_opt()
    jmodel, variables, port = flagship_pair(opt, seed=4)
    stats = variables["batch_stats"]
    port.train()
    for step in range(3):
        batch = synthetic_batch(opt, 4, seed=10 + step)
        _, mutated = jmodel.apply({**variables, "batch_stats": stats},
                                  batch, deterministic=False,
                                  mutable=["batch_stats"],
                                  rngs={"dropout": jax.random.PRNGKey(0)})
        stats = mutated["batch_stats"]
        with torch.no_grad():
            port(device_batch(batch, "cpu"))
    port.eval()
    got = variables_to_jax(port)["batch_stats"]
    flat_got = jax.tree_util.tree_leaves_with_path(got)
    flat_want = dict(jax.tree_util.tree_leaves_with_path(stats))
    flat_start = dict(jax.tree_util.tree_leaves_with_path(
        variables["batch_stats"]))
    assert len(flat_got) == len(flat_want) == 6    # a, m, i x (mean, var)
    for path, value in flat_got:
        np.testing.assert_allclose(value, np.asarray(flat_want[path]),
                                   rtol=0, atol=1e-6, err_msg=str(path))
        assert np.abs(value - flat_start[path]).max() > 1e-3
    # evaluation normalises with the moved statistics
    batch = synthetic_batch(opt, 3, seed=20)
    want = jmodel.apply({**variables, "batch_stats": stats}, batch,
                        deterministic=True)["logits"]
    with torch.no_grad():
        got_logits = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)


def test_variables_carry_the_running_stats(tmp_path):
    """Both ways and through a checkpoint, which ``load_best`` and
    ``load_model`` read with ``variables_from_jax``."""
    opt = _arb_opt()
    _, variables, port = flagship_pair(opt, seed=5)
    out = variables_to_jax(port)
    jax.tree.map(np.testing.assert_array_equal, out["batch_stats"],
                 jax.tree.map(np.asarray, variables["batch_stats"]))
    path = str(tmp_path / "best.ckpt")
    save_checkpoint(path, out, opt)
    loaded, _, _ = load_checkpoint(path, out)
    other = build_captioner(opt, device="cpu", seed=9)
    variables_from_jax(other, loaded)
    jax.tree.map(np.testing.assert_array_equal, variables_to_jax(other), out)
    bad = {**out, "batch_stats": {**out["batch_stats"], "extra": {
        "mean": np.zeros(3, np.float32)}}}
    with pytest.raises(KeyError, match="extra"):
        variables_from_jax(port, bad)
    with pytest.raises(KeyError, match="batch_stats"):
        variables_from_jax(port, {"params": out["params"]})
    with pytest.raises(KeyError, match="collections"):
        variables_from_jax(port, {**out, "cache": {}})


class _Loader:
    def __init__(self, batches):
        self.batches = batches

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)

    def set_epoch(self, epoch):
        pass


def test_arb_trains_and_resumes_with_its_running_stats(tmp_path):
    """Dropout on: two epochs straight against one epoch with its state
    saved and a fresh trainer resuming to two. Losses, parameters and
    running statistics equal."""
    def run(path, epochs, state_dir):
        opt = _arb_opt(epochs=epochs, resume=bool(state_dir),
                       train_state_dir=state_dir, hidden_dropout_prob=0.1,
                       encoder_dropout_prob=0.1,
                       checkpoint_path=str(path))
        batches = [synthetic_batch(opt, 4, seed=30 + i) for i in range(2)]
        tr = Trainer(opt, _Loader(batches), device="cpu")
        tr.fit()
        return tr

    full = run(tmp_path / "a", 2, "")
    start = Trainer(_arb_opt(), device="cpu")
    start.init_model()
    moved = variables_to_jax(full.model)["batch_stats"]
    init = variables_to_jax(start.model)["batch_stats"]
    assert all(np.abs(a - b).max() > 1e-3 for a, b in zip(
        jax.tree.leaves(moved), jax.tree.leaves(init)))
    state_dir = str(tmp_path / "state")
    run(tmp_path / "b", 1, state_dir)
    resumed = run(tmp_path / "b", 2, state_dir)
    assert resumed.history[0]["step_losses"] == full.history[1]["step_losses"]
    jax.tree.map(np.testing.assert_array_equal,
                 variables_to_jax(full.model), variables_to_jax(resumed.model))
