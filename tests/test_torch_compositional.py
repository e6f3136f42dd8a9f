"""Semantic composition (``compositional_intra`` / ``compositional_inter`` /
``compositional_ffn``) against the JAX package: ``CompositionalLinear``,
the compositional attention and FFN sublayers, and whole models with each
flag and all three, full forward, KV-cached step and beam search.

The projections take the concept distribution ``preds_attr`` per video; the
decode step takes it repeated per beam (the cross K/V stay at the
instances' rows), and the beam reorder leaves it alone. Test size, f32,
dropout off; logits within 2e-4, beams token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models import common as jcommon
from care_tpu.models import layers as jlayers
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import common as pcommon
from care_tpu_torch.models import layers as players
from care_tpu_torch.models.weights import params_from_jax
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (decoder_inputs, flagship_pair,
                                per_step_logits_jax, per_step_logits_port,
                                randomized, synthetic_batch, to_numpy,
                                token_sequence)
from torch_paper_grid import tiny_opt

D, F_SCALE, SEM, B, L = 16, 2, 12, 3, 5
GEN = torch.Generator().manual_seed(0)


def _pair(jmodule, pmodule, *args, seed=0, **kwargs):
    variables = jmodule.init(jax.random.PRNGKey(seed), *args, **kwargs)
    params = randomized(to_numpy(variables["params"]), seed + 1)
    params_from_jax(pmodule, params)
    return {"params": params}


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("x_rank", [2, 3])
def test_compositional_linear_matches_jax(x_rank):
    rs = np.random.RandomState(1)
    x = rs.randn(*((B, L, 10) if x_rank == 3 else (B, 10))).astype(
        np.float32)
    sem = rs.rand(B, SEM).astype(np.float32)
    jm = jcommon.CompositionalLinear(D, D // F_SCALE, SEM, 10)
    pm = pcommon.CompositionalLinear(D, D // F_SCALE, SEM, 10, GEN)
    variables = _pair(jm, pm, x, sem)
    np.testing.assert_allclose(pm(_t(x), _t(sem)).detach().numpy(),
                               np.asarray(jm.apply(variables, x, sem)),
                               rtol=0, atol=1e-5)


def test_compositional_attention_and_ffn_match_jax():
    rs = np.random.RandomState(2)
    x = rs.randn(B, L, D).astype(np.float32)
    enc = rs.randn(B, 7, 2 * D).astype(np.float32)
    sem = rs.rand(B, SEM).astype(np.float32)
    common = dict(num_attention_heads=4, hidden_dropout_prob=0.0,
                  layer_norm_eps=1e-12, dim_semantic=SEM,
                  dim_factor_scale=F_SCALE)
    jm = jlayers.MultiHeadAttention(dim_hidden=D, dim_key=2 * D,
                                    dim_value=2 * D, compositional=True,
                                    **common)
    pm = players.MultiHeadAttention(D, generator=GEN, dim_key=2 * D,
                                    dim_value=2 * D, compositional=True,
                                    **common)
    variables = _pair(jm, pm, x, enc, preds_attr=sem)
    want = jm.apply(variables, x, enc, preds_attr=sem)
    got = pm(_t(x), _t(enc), preds_attr=_t(sem))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=0, atol=1e-5)
    # the decode step's query projection
    q = pm.project_q(_t(x), _t(sem))
    np.testing.assert_allclose(q.detach().numpy(), np.asarray(
        jm.apply(variables, x, sem, method=jm.project_q)), rtol=0,
        atol=1e-5)

    jf = jlayers.PositionwiseFeedForward(
        dim_hidden=D, dim_intermediate=2 * D, hidden_dropout_prob=0.0,
        compositional=True, dim_semantic=SEM, dim_factor_scale=F_SCALE)
    pf = players.PositionwiseFeedForward(
        D, 2 * D, "relu", 0.0, 1e-12, GEN, compositional=True,
        dim_semantic=SEM, dim_factor_scale=F_SCALE)
    variables = _pair(jf, pf, x, preds_attr=sem)
    np.testing.assert_allclose(
        pf(_t(x), _t(sem)).detach().numpy(),
        np.asarray(jf.apply(variables, x, preds_attr=sem)), rtol=0,
        atol=1e-5)


GLSG = dict(dataset="MSRVTT", arch="base", method="Transformer",
            task="Concept", feats="ViT", decoder_modality_flags="VA",
            predictor_modality_flags="VAT")


@pytest.mark.parametrize("flags", [
    ("compositional_intra",), ("compositional_inter",),
    ("compositional_ffn",),
    ("compositional_intra", "compositional_inter", "compositional_ffn")])
def test_compositional_model_matches_jax(flags):
    """G0Lc with the hybrid bias and the flags on, two decoder layers."""
    opt = tiny_opt(dict(GLSG, use_attr_flags="G0Lc",
                        add_hybrid_attention_bias=True,
                        final_overrides=dict(
                            num_hidden_layers_decoder=2,
                            **{f: True for f in flags})))
    jmodel, variables, port = flagship_pair(opt, seed=4)
    batch = synthetic_batch(opt, 3, seed=5)
    want = jmodel.apply(variables, batch, deterministic=True)["logits"]
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    assert "preds_attr" in pinputs
    seq = token_sequence(opt, 3, seed=6)
    kv = per_step_logits_port(port, pinputs, torch.as_tensor(seq).long(),
                              max_len=opt["max_len"])
    np.testing.assert_allclose(
        kv, per_step_logits_jax(jmodel, variables, jinputs,
                                jnp.asarray(seq)), rtol=0, atol=2e-4)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": batch["feats"]})
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": batch["feats"]})
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


def test_decode_state_keeps_preds_attr_per_beam():
    """The decode state holds ``preds_attr`` at B*beam rows (an instance's
    beams share its row) and the cross K/V at B rows; a beam reorder does
    not touch either."""
    opt = tiny_opt(dict(GLSG, use_attr_flags="G0Lc", final_overrides=dict(
        compositional_intra=True, compositional_inter=True)))
    _, _, port = flagship_pair(opt, seed=7)
    batch = synthetic_batch(opt, 2, seed=8)
    with torch.no_grad():
        enc = port.encoding_phase([torch.as_tensor(f)
                                   for f in batch["feats"]])
        inputs = port.prepare_inputs_for_decoder(enc, {})
        state = port.init_decode_state(inputs, opt["max_len"], beam_size=5)
    pa = state["aux"]["preds_attr"]
    assert pa.shape[0] == 10
    assert torch.equal(pa, inputs["preds_attr"].repeat_interleave(5, 0))
    assert state["layers"][0]["inter_kv"][0].shape[0] == 2
    from care_tpu_torch.decoding.translator import _gather_self_kv
    moved = _gather_self_kv(state, torch.tensor([4, 3, 2, 1, 0] * 2))
    assert moved["aux"]["preds_attr"] is pa
