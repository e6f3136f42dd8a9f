"""Concept heads, the text stream, the MLP head and the gated attention
against the JAX package:

* multi-flag concept heads (one ``prj_<flag>`` each, or the shared
  ``prj``) and the decoder-side flags ``I``, ``S``, ``VI``, ``VS``: the
  criterion's losses through the model's ``project_attribute`` and every
  gradient of the first step; the trainer asks for the decoder's aux
  outputs exactly when the JAX trainer does;
* train-time sparse frame sampling: the masked noisy-OR merge, and the
  mask drawn from an explicit ``torch.Generator`` (repeatable from its
  seed, ceil(r * T) instances kept, none left out in evaluation);
* ``semantic_logits`` in the SemanticContainer;
* ``TextEmbedder`` for the ``t`` stream;
* ``MLPHead``, which serves densely (no fused head launch) as the JAX
  package rules;
* ``GatedMultiHeadAttention``.

Test size, f32, dropout off. Values within 2e-4 (losses 2e-5 relative,
gradients 1e-3 relative + 1e-6 absolute), beams token-identical.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models import embeddings as jemb
from care_tpu.models import framework as jfw
from care_tpu.models import layers as jlayers
from care_tpu.models import predictors as jpred
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu.training.trainer import Trainer as JaxTrainer
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import embeddings as pemb
from care_tpu_torch.models import framework as pfw
from care_tpu_torch.models import layers as players
from care_tpu_torch.models import predictors as ppred
from care_tpu_torch.models.weights import grads_to_jax, params_from_jax
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.training import Trainer
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (flagship_pair, randomized, synthetic_batch,
                                to_numpy)
from torch_paper_grid import tiny_opt

GEN = torch.Generator().manual_seed(0)
CARE = dict(dataset="MSRVTT", arch="base", method="Transformer",
            task="CARE", feats="ViT", decoder_modality_flags="VA",
            predictor_modality_flags="VAT")


def _leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}/")
        else:
            yield prefix + k, np.asarray(v)


@pytest.mark.parametrize("task,flags,share", [
    ("TAP", "I", False), ("TAP_RNN", "S", False), ("DAP", "VI", False),
    ("DAP", "VI", True), ("DAP_RNN", "VS", False)])
def test_concept_flags_match_jax(task, flags, share):
    """The tasks that train the decoder-side flags, on a Transformer
    decoder: the shared or per-flag heads, the losses of each flag and
    every gradient."""
    opt = tiny_opt(dict(dataset="MSRVTT", arch="base", method="Transformer",
                        task=task, feats="ViT", modality="mi",
                        final_overrides={
                            "attribute_prediction_share_prj": share}))
    assert opt["attribute_prediction_flags"] == flags
    jmodel, variables, port = flagship_pair(opt, seed=1)
    heads = port.predictor.Predictor_attribute.attribute_heads
    assert heads.shared == (share or len(flags) == 1)
    batch = synthetic_batch(opt, 3, seed=2)
    crit = JaxCriterion(opt)

    def loss_fn(p):
        out = jmodel.apply({"params": p}, batch, deterministic=True)

        def project_fn(feats, flag):
            return jmodel.apply({"params": p}, feats, flag,
                                method=JaxCaptioner.project_attribute)
        total, losses, _ = crit({**out, **batch}, project_fn)
        return total, losses

    (want, want_losses), want_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(variables["params"])
    tb = device_batch(batch, "cpu")
    total, losses, _ = Criterion(opt)({**port(tb), **tb},
                                      port.project_attribute)
    total.backward()
    assert set(losses) == set(want_losses) == (
        {f"{f}-Attr" for f in flags} | {"Lang Loss"})
    for k in losses:
        np.testing.assert_allclose(losses[k].item(), float(want_losses[k]),
                                   rtol=2e-5, err_msg=k)
    np.testing.assert_allclose(total.item(), float(want), rtol=2e-5)
    got = dict(_leaves(grads_to_jax(port)))
    want_g = dict(_leaves(to_numpy(want_grads)))
    assert sorted(got) == sorted(want_g)
    for path in want_g:
        np.testing.assert_allclose(got[path], want_g[path], rtol=1e-3,
                                   atol=1e-6, err_msg=path)
    assert Trainer(opt, device="cpu")._needs_aux == JaxTrainer(
        opt)._needs_aux == (flags != "V")


def test_sparse_sampling_mask_and_merge():
    rs = np.random.RandomState(3)
    scores = rs.randn(4, 6, 5).astype(np.float32)
    mask = rs.rand(4, 6) > 0.5
    mask[0] = True                  # a row that keeps nothing
    want = jpred.prepare_merged_probs(jnp.asarray(scores), jnp.asarray(mask),
                                      return_avg_prob=True)
    got = ppred.prepare_merged_probs(torch.as_tensor(scores),
                                     torch.as_tensor(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)

    opt = tiny_opt(dict(dataset="MSRVTT", arch="base", method="Transformer",
                        task="VAP", feats="ViT", modality="mi"))
    assert opt["attribute_prediction_sparse_sampling"]
    jmodel, variables, port = flagship_pair(opt, seed=4)
    det = port.predictor.Predictor_attribute

    def draw(seed):
        det.generator = torch.Generator().manual_seed(seed)
        return det.sampling_mask(64, 8, "cpu")
    first = draw(5)
    assert torch.equal(first, draw(5)) and not torch.equal(first, draw(6))
    kept = (~first).sum(dim=1)
    assert int(kept.min()) >= 1 and int(kept.max()) <= 8
    assert 0.3 < float(kept.float().mean()) / 8 < 0.8
    # training draws the mask; evaluation equals the JAX package's
    batch = synthetic_batch(opt, 3, seed=5)
    want = jmodel.apply(variables, batch, deterministic=True)["preds_attr"]
    tb = device_batch(batch, "cpu")
    with torch.no_grad():
        np.testing.assert_allclose(port(tb)["preds_attr"].numpy(),
                                   np.asarray(want), rtol=0, atol=1e-5)
        port.train()
        det.generator = torch.Generator().manual_seed(7)
        trained = port(tb)["preds_attr"]
        port.eval()
    assert not np.allclose(trained.numpy(), np.asarray(want), atol=1e-3)


def test_semantic_logits_match_jax():
    opt = tiny_opt(CARE)
    rs = np.random.RandomState(8)
    preds = rs.rand(3, opt["attribute_prediction_k"]).astype(np.float32)
    logits = [rs.randn(3, 5, opt["attribute_prediction_k"]).astype(
        np.float32)]
    opt["use_attr_topk"] = 4
    jm = jpred.SemanticContainer(opt)
    variables = jm.init(jax.random.PRNGKey(0), preds_attr=preds,
                        semantic_logits=logits)
    params = randomized(to_numpy(variables["params"]), 1)
    pm = ppred.SemanticContainer(opt, GEN)
    params_from_jax(pm, params)
    want = jm.apply({"params": params}, preds_attr=preds,
                    semantic_logits=logits)
    with torch.no_grad():
        got = pm(preds_attr=torch.as_tensor(preds),
                 semantic_logits=[torch.as_tensor(l) for l in logits])
    np.testing.assert_array_equal(got["semantic_labels"].numpy(),
                                  np.asarray(want["semantic_labels"]))
    for key in ("semantic_embs", "semantic_hidden_states"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=1e-5, err_msg=key)


class _JaxText(fnn.Module):
    opt: dict

    @fnn.compact
    def __call__(self, ids):
        emb = jemb.Embeddings(self.opt, name="emb")
        return jfw.TextEmbedder(self.opt, name="te")(
            ids, embeddings_module=emb)


class _PortText(nn.Module):
    """The decoder's embeddings (left out with ``has_retrieval_embs``, as
    flax leaves out a module that is never called) and the embedder."""

    def __init__(self, opt):
        super().__init__()
        self.emb = (None if opt["has_retrieval_embs"]
                    else pemb.Embeddings(opt, GEN))
        self.te = pfw.TextEmbedder(opt, GEN)

    def forward(self, ids):
        return self.te(ids, embeddings_module=self.emb)


@pytest.mark.parametrize("own_embs", [False, True])
def test_text_embedder_matches_jax(own_embs):
    opt = dict(tiny_opt(CARE), has_retrieval_embs=own_embs)
    ids = np.random.RandomState(9).randint(
        0, opt["vocab_size"], (2, 3, opt["max_len"])).astype(np.int32)
    jm = _JaxText(opt)
    variables = jm.init(jax.random.PRNGKey(1), ids)
    params = randomized(to_numpy(variables["params"]), 2)
    pm = _PortText(opt)
    params_from_jax(pm, params)
    with torch.no_grad():
        got = pm(torch.as_tensor(ids).long())
    assert got.shape == (2, 3, opt["max_len"], opt["dim_hidden"])
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jm.apply({"params": params}, ids)), rtol=0, atol=1e-5)


def test_mlp_head_serves_densely_as_jax(monkeypatch):
    opt = tiny_opt(dict(CARE, final_overrides={"cls_head": "MLPHead"}))
    jmodel, variables, port = flagship_pair(opt, seed=10)
    batch = synthetic_batch(opt, 3, seed=11)
    want = jmodel.apply(variables, batch, deterministic=True)["logits"]
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    calls = []
    plain = fht._stats_plain
    monkeypatch.setattr(fht, "_stats_plain",
                        lambda *a, **k: calls.append(1) or plain(*a, **k))
    translator = get_translator(opt, device="cpu")
    assert not translator.fused_head
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": batch["feats"]})
    got_h, got_s = translator.translate_batch(port,
                                              {"feats": batch["feats"]})
    assert got_h == want_h and not calls
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    trainer = Trainer(dict(opt, fused_xent=True), device="cpu")
    trainer.init_model()
    trainer._build_tx(1)
    trainer._make_train_step()
    assert trainer._fused_xent is False


@pytest.mark.parametrize("pre_ln,scalar_gate", [(False, False),
                                                (True, False), (False, True)])
def test_gated_attention_matches_jax(pre_ln, scalar_gate):
    rs = np.random.RandomState(12)
    x = rs.randn(2, 5, 16).astype(np.float32)
    kw = dict(num_attention_heads=4, hidden_dropout_prob=0.0,
              layer_norm_eps=1e-12, pre_ln=pre_ln)
    jm = jlayers.GatedMultiHeadAttention(dim_hidden=16,
                                         scalar_gate=scalar_gate,
                                         mha_kwargs=kw)
    variables = jm.init(jax.random.PRNGKey(2), x)
    params = randomized(to_numpy(variables["params"]), 3)
    pm = players.GatedMultiHeadAttention(16, GEN, scalar_gate=scalar_gate,
                                         **kw)
    params_from_jax(pm, params)
    want_out, (want_p, want_g), want_c = jm.apply({"params": params}, x)
    with torch.no_grad():
        out, (p, g), c = pm(torch.as_tensor(x))
    for a, b in ((out, want_out), (p, want_p), (g, want_g), (c, want_c)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5)
