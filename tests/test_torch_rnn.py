"""The RNN captioners of the port (``care_tpu_torch/models/decoders.py``'s
RNN section and ``models/encoders.py:VOE``) held against the JAX package's,
module by module, on the same weights and inputs (f32, dropout off):

* the torch-layout cells against ``care_tpu``'s and against
  ``torch.nn.LSTMCell`` / ``GRUCell``, their init; flax's GRU cell;
* the additive attention (with and without the hybrid bias, shared or
  per-list weights) and the multi-level attention;
* VOE's chained GRUs and its BatchNorm in training mode (outputs and
  running statistics);
* each decoder's step (``rnn_decode_step`` from ``init_rnn_carry``) against
  the JAX package's and against its own time loop;
* the one-hot category through the translator, GRU cells, ``rnn_use_mha``,
  the multi-level attention and the concept-slot attention, with beams
  token-identical; a ``t`` stream refused beside an RNN decoder;
* bf16 serving against the JAX package's bf16 step.

``tests/test_torch_rnn_train.py`` holds scheduled sampling, resume,
pretrained word tables and the entry points on an RNN checkpoint.

Logits within 2e-4, beams token-identical, as the rest of the port's tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.decoding.translator import _cast_variables as jax_cast
from care_tpu.models import build_captioner as jax_build_captioner
from care_tpu.models import decoders as jax_decoders
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models import decoders as port_decoders
from care_tpu_torch.models.encoders import GRUCellFlax
from care_tpu_torch.models.weights import (params_from_jax, params_to_jax,
                                           variables_from_jax)

from test_torch_support import (flagship_pair, randomized, synthetic_batch,
                                tensors, to_numpy, token_sequence)
from torch_paper_grid import VERS_MSRVTT, held_against_jax, tiny_opt

SALSTM_CARE = dict(VERS_MSRVTT, method="SALSTM", task="CARE")
TOPDOWN_CARE = dict(VERS_MSRVTT, method="TopDown", task="CARE")
VOE = dict(VERS_MSRVTT, method="VOE", task="Base")


def _opt(overrides, **extra):
    """``tiny_opt`` of the command with ``extra`` set after the presets
    (which would otherwise override ``rnn_type`` or ``fusion``)."""
    return dict(tiny_opt(overrides), **extra)


class _Holder(nn.Module):
    """A module under the name ``m``, so that its own parameters have a
    flax path."""

    def __init__(self, module):
        super().__init__()
        self.m = module


def _jax_params(module):
    return jax.tree.map(jnp.asarray, params_to_jax(_Holder(module))["m"])


def _randomize(module, seed):
    holder = _Holder(module)
    params_from_jax(holder, randomized(params_to_jax(holder), seed))
    return module


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

def test_lstm_cell_matches_jax_and_torch():
    g = torch.Generator().manual_seed(0)
    cell = port_decoders.LSTMCellTorch(12, 8, g)
    k = 1 / 8 ** 0.5
    for layer in (cell.ih, cell.hh):
        forget = layer.bias[8:16]
        others = torch.cat([layer.bias[:8], layer.bias[16:]])
        assert ((forget >= 1 - k) & (forget <= 1 + k)).all()
        assert (others.abs() <= k).all() and (layer.weight.abs() <= k).all()
    rs = np.random.RandomState(1)
    h, c, x = (rs.randn(3, n).astype(np.float32) for n in (8, 8, 12))
    got_h, got_c = cell(tensors([h, c]), torch.as_tensor(x))
    (want_h, want_c), _ = jax_decoders.LSTMCellTorch(8).apply(
        {"params": _jax_params(cell)}, (jnp.asarray(h), jnp.asarray(c)),
        jnp.asarray(x))
    ref = nn.LSTMCell(12, 8)
    with torch.no_grad():
        ref.weight_ih.copy_(cell.ih.weight)
        ref.weight_hh.copy_(cell.hh.weight)
        ref.bias_ih.copy_(cell.ih.bias)
        ref.bias_hh.copy_(cell.hh.bias)
        ref_h, ref_c = ref(torch.as_tensor(x), tuple(tensors([h, c])))
    for got, want in ((got_h, want_h), (got_c, want_c), (got_h, ref_h),
                      (got_c, ref_c)):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   rtol=0, atol=1e-6)


def test_gru_cells_match_jax_and_torch():
    g = torch.Generator().manual_seed(0)
    cell = port_decoders.GRUCellTorch(12, 8, g)
    rs = np.random.RandomState(2)
    h, x = rs.randn(3, 8).astype(np.float32), rs.randn(3, 12).astype(
        np.float32)
    got = cell(torch.as_tensor(h), torch.as_tensor(x))
    want, _ = jax_decoders.GRUCellTorch(8).apply(
        {"params": _jax_params(cell)}, jnp.asarray(h), jnp.asarray(x))
    ref = nn.GRUCell(12, 8)
    with torch.no_grad():
        ref.weight_ih.copy_(torch.cat([cell.ih_rz.weight, cell.ih_n.weight]))
        ref.weight_hh.copy_(torch.cat([cell.hh_rz.weight, cell.hh_n.weight]))
        ref.bias_ih.copy_(torch.cat([cell.ih_rz.bias, cell.ih_n.bias]))
        ref.bias_hh.copy_(torch.cat([cell.hh_rz.bias, cell.hh_n.bias]))
        ref_h = ref(torch.as_tensor(x), torch.as_tensor(h))
    for other in (np.asarray(want), ref_h.numpy()):
        np.testing.assert_allclose(got.detach().numpy(), other, rtol=0,
                                   atol=1e-6)

    # flax's GRU cell (VOE's), stepped over time from a carry
    import flax.linen as fnn
    flax_cell = _randomize(GRUCellFlax(12, 8, g), 3)
    assert flax_cell.hr.bias is None and flax_cell.hz.bias is None
    xs = rs.randn(3, 5, 12).astype(np.float32)
    with torch.no_grad():
        carry, outs = flax_cell.scan(torch.as_tensor(xs), torch.as_tensor(h))
    want_carry, want_outs = fnn.RNN(fnn.GRUCell(8), return_carry=True).apply(
        {"params": {"cell": _jax_params(flax_cell)}}, jnp.asarray(xs),
        initial_carry=jnp.asarray(h))
    np.testing.assert_allclose(outs.numpy(), np.asarray(want_outs), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(carry.numpy(), np.asarray(want_carry), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# attentions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_feats,share,hybrid", [
    (1, False, 0), (1, False, 10), (3, False, 0), (3, True, 0)])
def test_additive_attention_matches_jax(n_feats, share, hybrid):
    g = torch.Generator().manual_seed(4)
    att = _randomize(port_decoders.AdditiveAttention(
        8, 6, 8, g, n_feats=n_feats, feats_share_weights=share,
        hybrid_length=hybrid), 5)
    assert (att.hybrid_bias is None) == (not hybrid)
    rs = np.random.RandomState(6)
    h = rs.randn(2, 8).astype(np.float32)
    feats = [rs.randn(2, hybrid or 7, 8).astype(np.float32)
             for _ in range(n_feats)]
    with torch.no_grad():
        got_ctx, got_p = att(torch.as_tensor(h), tensors(feats))
    want_ctx, want_p = jax_decoders.AdditiveAttention(
        8, 6, num_feats=n_feats, feats_share_weights=share,
        add_hybrid_attention_bias=bool(hybrid),
        hybrid_length=hybrid).apply(
            {"params": _jax_params(att)}, jnp.asarray(h),
            [jnp.asarray(f) for f in feats])
    assert got_ctx.shape == (2, 8 * n_feats)
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("share", [False, True])
def test_multilevel_attention_matches_jax(share):
    g = torch.Generator().manual_seed(7)
    att = _randomize(port_decoders.MultiLevelAttention(8, 8, 8, 3, g,
                                                       share), 8)
    rs = np.random.RandomState(9)
    h = rs.randn(2, 8).astype(np.float32)
    feats = [rs.randn(2, 5, 8).astype(np.float32) for _ in range(3)]
    with torch.no_grad():
        got_ctx, got_p = att(torch.as_tensor(h), tensors(feats))
    want_ctx, want_p = jax_decoders.MultiLevelAttention(
        8, 8, num_feats=3, feats_share_weights=share).apply(
            {"params": _jax_params(att)}, jnp.asarray(h),
            [jnp.asarray(f) for f in feats])
    np.testing.assert_allclose(got_ctx.numpy(), np.asarray(want_ctx),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# VOE
# ---------------------------------------------------------------------------

def test_voe_encoder_trains_its_batchnorm_as_jax():
    """VOE in training mode: the encoder states and the BatchNorm's moved
    running statistics (from randomized ones) equal the JAX package's."""
    opt = _opt(VOE)
    jmodel, variables, port = flagship_pair(opt, seed=11)
    feats = synthetic_batch(opt, 3, seed=12)["feats"]
    want, mutated = jmodel.apply(
        variables, [jnp.asarray(f) for f in feats], deterministic=False,
        method=JaxCaptioner.encoding_phase, mutable=["batch_stats"])
    port.train()
    got = port.encoding_phase(tensors(feats))
    np.testing.assert_allclose(got["encoder_hidden_states"].detach().numpy(),
                               np.asarray(want["encoder_hidden_states"]),
                               rtol=0, atol=2e-5)
    bn = port.encoder.bn.bn
    want_bn = mutated["batch_stats"]["encoder"]["bn"]["bn"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(want_bn["mean"]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(want_bn["var"]), rtol=0, atol=1e-6)
    start = variables["batch_stats"]["encoder"]["bn"]["bn"]["mean"]
    assert np.abs(bn.running_mean.numpy() - start).max() > 1e-3


# ---------------------------------------------------------------------------
# the decode step and the time loop
# ---------------------------------------------------------------------------

def _step_logits(jmodel, variables, port, batch, seq):
    """Both packages' logits [B, L, V] of ``rnn_decode_step`` over ``seq``
    from ``init_rnn_carry``, and the port's time loop over ``seq``."""
    from test_torch_support import decoder_inputs
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    carry = jmodel.apply(variables, jinputs,
                         method=JaxCaptioner.init_rnn_carry)
    want = []
    for t in range(seq.shape[1]):
        logits, carry = jmodel.apply(variables, jnp.asarray(seq[:, t]),
                                     carry, jinputs,
                                     method=JaxCaptioner.rnn_decode_step)
        want.append(np.asarray(logits))
    got = []
    with torch.no_grad():
        pcarry = port.init_rnn_carry(pinputs)
        for t in range(seq.shape[1]):
            logits, pcarry = port.rnn_decode_step(
                torch.as_tensor(seq[:, t]).long(), pcarry, pinputs)
            got.append(logits.numpy())
        loop = port.decoding_phase(torch.as_tensor(seq).long(),
                                   pinputs)["logits"].numpy()
    return np.stack(got, 1), np.stack(want, 1), loop


@pytest.mark.parametrize("overrides,extra", [
    (SALSTM_CARE, {}), (TOPDOWN_CARE, {}), (VOE, {}),
    (TOPDOWN_CARE, {"rnn_type": "gru"}),
    (SALSTM_CARE, {"rnn_type": "gru", "rnn_use_mha": True})],
    ids=["SALSTM", "TopDown", "VOE", "TopDown-gru", "SALSTM-gru-mha"])
def test_decode_step_matches_jax_and_the_loop(overrides, extra):
    opt = _opt(overrides, **extra)
    jmodel, variables, port = flagship_pair(opt, seed=13)
    batch = synthetic_batch(opt, 3, seed=14)
    seq = token_sequence(opt, 3, seed=15)
    got, want, loop = _step_logits(jmodel, variables, port, batch, seq)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(got, loop, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# options through the translator
# ---------------------------------------------------------------------------

def _one_hot_pair(opt, seed):
    """``flagship_pair`` for a ``with_category`` RNN model, whose JAX side
    is initialised with the dataset's one-hot category rows."""
    jmodel = jax_build_captioner(opt)
    batch = synthetic_batch(opt, 2, seed)
    batch["category"] = _one_hot(opt, 2, seed)
    key = jax.random.PRNGKey(seed)
    variables = jmodel.init({"params": key, "dropout": key}, batch,
                            deterministic=True)
    out = {"params": randomized(to_numpy(variables["params"]), seed + 1)}
    port = build_captioner(opt, device="cpu", seed=seed)
    variables_from_jax(port, out)
    return jmodel, out, port


def _one_hot(opt, n, seed):
    rows = np.zeros((n, opt["num_category"]), np.float32)
    rows[np.arange(n), np.random.RandomState(seed).randint(
        0, opt["num_category"], n)] = 1.0
    return rows


@pytest.mark.parametrize("overrides", [SALSTM_CARE, TOPDOWN_CARE],
                         ids=["SALSTM", "TopDown"])
def test_one_hot_category_through_the_translator(overrides):
    opt = _opt(overrides, with_category=True)
    jmodel, variables, port = _one_hot_pair(opt, seed=23)
    batch = {"feats": synthetic_batch(opt, 3, seed=24)["feats"],
             "category": _one_hot(opt, 3, seed=25)}
    tr = get_translator(opt, device="cpu")
    assert not tr.fused_head
    assert tr._batch_inputs(batch)["category"].dtype == torch.float32
    got_h, got_s = tr.translate_batch(port, batch)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], batch)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    assert tr.beam_steps > 0


@pytest.mark.parametrize("overrides,extra", [
    (SALSTM_CARE, {"rnn_type": "gru"}),
    (TOPDOWN_CARE, {"rnn_type": "gru"}),
    (SALSTM_CARE, {"rnn_use_mha": True}),
    (TOPDOWN_CARE, {"rnn_use_mha": True}),
    (VOE, {"with_multileval_attention": True, "fusion": "none",
           "feats_share_weights": True}),
    (dict(VERS_MSRVTT, method="SALSTM", task="Base"),
     {"with_multileval_attention": True, "fusion": "none"}),
    (TOPDOWN_CARE, {"use_attr_type": "emb_att",
                    "add_hybrid_attention_bias": False}),
    (SALSTM_CARE, {"use_attr_type": "att",
                   "add_hybrid_attention_bias": False}),
], ids=["SALSTM-gru", "TopDown-gru", "SALSTM-mha", "TopDown-mha",
        "VOE-multilevel-shared", "SALSTM-multilevel", "TopDown-emb-att",
        "SALSTM-att"])
def test_rnn_options_match_jax(overrides, extra):
    opt = _opt(overrides, **extra)
    err, want_h, got_h, want_s, got_s = held_against_jax(opt)
    assert err <= 2e-4, err
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


def test_text_stream_needs_a_transformer_decoder():
    opt = _opt(dict(VERS_MSRVTT, method="SALSTM", task="Base"),
               modality="amit", has_retrieval_embs=False)
    port = build_captioner(opt, device="cpu")
    feats = synthetic_batch(dict(opt, modality="ami"), 2, seed=28)["feats"]
    ids = torch.randint(6, opt["vocab_size"], (2, 3, opt["max_len"]))
    with pytest.raises(ValueError, match="transformer decoder"):
        port.encoding_phase(tensors(feats) + [ids])


@pytest.mark.parametrize("overrides", [SALSTM_CARE,
                                       dict(VERS_MSRVTT, method="SALSTM",
                                            task="Base")],
                         ids=["CARE", "Base"])
def test_bf16_decode_steps_match_jax(overrides):
    """The bf16 serving copy's decode steps (BOS, then the JAX package's
    greedy token) against the JAX package's bf16 step: log-probs within 2%
    of the step's largest |log-prob| (the bound of the bf16 Transformer
    decode, ``tests/test_torch_fused_decode.py``), and the cell's state in
    the JAX package's dtype."""
    opt = _opt(overrides)
    jmodel, variables, port = flagship_pair(opt, seed=29)
    feats = synthetic_batch(opt, 3, seed=30)["feats"]
    jv = jax_cast(variables, jnp.bfloat16, False)
    jf = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    jin = jmodel.apply(jv, jmodel.apply(jv, jf,
                                        method=JaxCaptioner.encoding_phase),
                       {}, method=JaxCaptioner.prepare_inputs_for_decoder)
    jcarry = jmodel.apply(jv, jin, method=JaxCaptioner.init_rnn_carry)
    tr = get_translator(dict(opt, compute_dtype_decode="bfloat16"),
                        device="cpu")
    served = tr.serving_model(port)
    assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    with torch.no_grad():
        pin = served.prepare_inputs_for_decoder(
            served.encoding_phase(tr._feats({"feats": feats})), {})
        pcarry = served.init_rnn_carry(pin)
    tokens = np.full((3,), 2)
    for _ in range(3):
        jl, jcarry = jmodel.apply(jv, jnp.asarray(tokens), jcarry, jin,
                                  method=JaxCaptioner.rnn_decode_step)
        with torch.no_grad():
            pl, pcarry = served.rnn_decode_step(torch.as_tensor(tokens),
                                                pcarry, pin)
        want = np.asarray(jax.nn.log_softmax(jl.astype(jnp.float32)))
        got = torch.log_softmax(pl.float(), dim=-1).numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-2 * np.abs(want).max())
        assert str(pcarry[0].dtype)[6:] == str(jcarry[0].dtype)
        tokens = want.argmax(axis=-1)
    hyps, scores = tr.translate_batch(port, {"feats": feats})
    assert len(hyps) == 3 and all(np.isfinite(s[0]) for s in scores)
