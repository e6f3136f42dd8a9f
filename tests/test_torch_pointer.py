"""The PointerGen copy head and the retrieved-caption options of the port
(``care_tpu_torch/models/pointer.py``, ``models/framework.py``'s
``TextEmbedder``, ``use_category_embs``) held against the JAX package's on
the same weights and inputs (f32, dropout off):

* ``Pointer`` alone, with PAD in the retrieved ids, ids repeated within and
  across retrievals, ``copy_scale`` 1 and 0.35, both
  ``last_time_step_logits`` forms;
* the deterministic scatter against a plain ``scatter_add``, values and
  gradients;
* the KV-cached step's log-probabilities against the full forward and
  against the JAX package's step;
* the language loss on the pointer's ``probs``;
* ``has_retrieval_rnn`` (flax's ``OptimizedLSTMCell`` both ways) and
  ``use_category_embs`` (a ``Dense`` that takes its width from its first
  call), full forward and beams;
* a bf16 decode whose retrieved ids reach the pointer unrounded.

Log-probabilities within 2e-4, beams token-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu.models.pointer import Pointer as JaxPointer
from care_tpu.training.losses import lang_loss as jax_lang_loss
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.common import Dense, LazyDense
from care_tpu_torch.models.pointer import Pointer, copy_scatter
from care_tpu_torch.models.weights import params_from_jax
from care_tpu_torch.training.losses import lang_loss
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (decoder_inputs, flagship_pair, randomized,
                                retrieved_ids, synthetic_batch, to_numpy,
                                token_sequence)
from torch_paper_grid import VERS_MSRVTT, tiny_opt

POINTER_BASE = dict(VERS_MSRVTT, method="PointerGen", task="Base")
TOL = 2e-4


def _opt(**extra):
    return dict(tiny_opt(POINTER_BASE), **extra)


@pytest.mark.parametrize("last", [False, True])
@pytest.mark.parametrize("copy_scale", [1.0, 0.35])
def test_pointer_matches_jax(last, copy_scale):
    opt = dict(dim_hidden=8, attention_probs_dropout_prob=0.0,
               copy_scale=copy_scale, layer_norm_eps=1e-12)
    rs = np.random.RandomState(1)
    B, R, S, T, D, V = 2, 3, 6, 4, 8, 20
    ids = retrieved_ids(dict(retrieval_topk=R, max_len=S, vocab_size=V), B,
                        seed=2)
    ids[0, 1, :] = 0                     # one retrieval all PAD
    assert (ids[:, :, :, None] == ids[:, :, None, :]).sum() > B * R * S
    hidden = rs.randn(B, T, D).astype(np.float32)
    embs = rs.randn(B, R, S, D).astype(np.float32)
    logits = rs.randn(*((B, V) if last else (B, T, V))).astype(np.float32)
    jp = JaxPointer(opt)
    params = jp.init(jax.random.PRNGKey(0), hidden, embs, ids, logits,
                     last_time_step_logits=last)["params"]
    params = randomized(to_numpy(params), 3, scale=0.3)
    assert sorted(params) == ["Wc", "Wq", "attention"]
    assert sorted(params["attention"]) == ["key", "query", "value"]
    want = jp.apply({"params": params}, hidden, embs, ids, logits,
                    last_time_step_logits=last)["probs"]
    port = params_from_jax(Pointer(opt, torch.Generator().manual_seed(0)),
                           params)
    with torch.no_grad():
        got = port(torch.as_tensor(hidden), torch.as_tensor(embs),
                   torch.as_tensor(ids).long(), torch.as_tensor(logits),
                   last_time_step_logits=last)["probs"]
    assert got.shape == ((B, V) if last else (B, T, V))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, atol=1e-5)


def test_copy_scatter_matches_scatter_add():
    rs = np.random.RandomState(4)
    N, S, V = 7, 9, 12
    ids = torch.as_tensor(rs.randint(0, 5, (N, S)))     # many repeats
    base = torch.tensor(rs.rand(N, V), requires_grad=True)
    src = torch.tensor(rs.rand(N, S), requires_grad=True)
    got = copy_scatter(base, ids, src)
    want = base.scatter_add(1, ids, src)
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=0, atol=1e-12)
    cot = torch.as_tensor(rs.randn(N, V))
    g_got = torch.autograd.grad(got, (base, src), cot)
    g_want = torch.autograd.grad(want, (base, src), cot)
    for a, b in zip(g_got, g_want):
        assert torch.equal(a, b)
    # the same inputs give the same bits
    assert torch.equal(copy_scatter(base, ids, src), got)


def _pointer_pair(opt, seed=3):
    jmodel, variables, port = flagship_pair(opt, seed=seed)
    batch = synthetic_batch(opt, 3, seed=seed + 1)
    return jmodel, variables, port, batch


def test_step_log_probs_match_full_forward_and_jax():
    opt = _opt()
    jmodel, variables, port, batch = _pointer_pair(opt)
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    seq = token_sequence(opt, 3, seed=9)
    L = seq.shape[1]
    state = jmodel.apply(variables, jinputs, opt["max_len"],
                         method=JaxCaptioner.init_decode_state)
    want = []
    for t in range(L):
        out, state, is_prob = jmodel.apply(
            variables, jnp.asarray(seq[:, t]), jnp.asarray(t), state,
            jinputs, method=JaxCaptioner.decode_step)
        assert is_prob
        want.append(np.asarray(out))
    want = np.stack(want, axis=1)
    tseq = torch.as_tensor(seq).long()
    with torch.no_grad():
        state = port.init_decode_state(pinputs, opt["max_len"])
        step, full = [], []
        for t in range(L):
            out, state, is_prob = port.decode_step(tseq[:, t], t, state,
                                                   pinputs)
            assert is_prob
            step.append(out)
            probs = port.decoding_phase(tseq[:, :t + 1], pinputs,
                                        last_time_step_logits=True)["probs"]
            full.append(torch.log(probs + 1e-9))
        # without the decoder inputs the step gives the head's logits
        _, _, is_prob = port.decode_step(
            tseq[:, 0], 0, port.init_decode_state(pinputs, opt["max_len"]))
        assert not is_prob
    step = torch.stack(step, dim=1).numpy()
    np.testing.assert_allclose(step, torch.stack(full, 1).numpy(), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(step, want, rtol=0, atol=TOL)


def test_lang_loss_on_probs_matches_jax():
    opt = dict(_opt(), label_smoothing=0.1)
    rs = np.random.RandomState(5)
    B, L, V = 3, opt["max_len"] - 1, opt["vocab_size"]
    logits = rs.randn(B, L, V).astype(np.float32)
    probs = rs.rand(B, L, V).astype(np.float32)
    probs /= probs.sum(-1, keepdims=True)
    labels = rs.randint(1, V, (B, L)).astype(np.int32)
    labels[:, -3:] = 0
    total, metrics = jax_lang_loss(opt, {"logits": logits, "probs": probs,
                                         "labels": labels})
    got, got_m = lang_loss(opt, {"logits": torch.as_tensor(logits),
                                 "probs": torch.as_tensor(probs),
                                 "labels": torch.as_tensor(labels).long()})
    np.testing.assert_allclose(got.item(), float(total), rtol=1e-6)
    assert sorted(got_m) == sorted(metrics)
    for k in metrics:
        np.testing.assert_allclose(got_m[k].item(), float(metrics[k]),
                                   rtol=1e-6, err_msg=k)
    # the probabilities, not the logits, decide the loss
    plain, _ = lang_loss(opt, {"logits": torch.as_tensor(logits),
                               "labels": torch.as_tensor(labels).long()})
    assert abs(plain.item() - got.item()) > 0.1


def _forward_and_beams(opt, aux_keys=()):
    jmodel, variables, port, batch = _pointer_pair(opt)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    for key in ("logits", "probs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=TOL, err_msg=key)
    dec = {"feats": batch["feats"], **{k: batch[k] for k in aux_keys}}
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], dec)
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, dec)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=TOL)
    return variables, port, batch


@pytest.mark.parametrize("own_embs", [False, True])
def test_retrieval_rnn_matches_flax(own_embs):
    opt = _opt(has_retrieval_rnn=True, has_retrieval_embs=own_embs)
    variables, port, _ = _forward_and_beams(opt)
    cell = variables["params"]["text_embedder"]["rnn_bwd"]["cell"]
    assert sorted(cell) == sorted(["ii", "if", "ig", "io",
                                   "hi", "hf", "hg", "ho"])
    assert sorted(cell["if"]) == ["kernel"]
    assert sorted(cell["hf"]) == ["bias", "kernel"]
    # the port's own init: lecun-normal input, orthogonal recurrent maps,
    # zero biases
    fresh = build_captioner(opt, device="cpu").text_embedder.rnn_fwd.cell
    w = getattr(fresh, "hg").weight
    np.testing.assert_allclose((w @ w.T).detach().numpy(),
                               np.eye(w.shape[0]), atol=1e-5)
    assert torch.count_nonzero(getattr(fresh, "hi").bias) == 0
    assert getattr(fresh, "if").weight.abs().max() <= 2 * (
        1 / opt["dim_hidden"]) ** 0.5 / 0.87962566103423978


def test_category_embs_take_their_width_from_the_first_call():
    opt = _opt(with_category=True, use_category_embs=True, dim_category=6)
    fresh = build_captioner(opt, device="cpu")
    layer = fresh.decoder.embedding.category_embeddings
    assert isinstance(layer, LazyDense)
    assert isinstance(layer.weight, torch.nn.parameter.UninitializedParameter)
    batch = synthetic_batch(opt, 2, seed=1)
    with torch.no_grad():
        fresh(device_batch(batch, "cpu"))
    assert type(layer) is Dense and layer.weight.shape == (
        opt["dim_hidden"], 6)
    variables, port, batch = _forward_and_beams(opt, ("category_embs",))
    assert variables["params"]["decoder"]["embedding"][
        "category_embeddings"]["kernel"].shape == (6, opt["dim_hidden"])
    # the vectors move the logits
    moved = dict(batch, category_embs=batch["category_embs"] + 10.0)
    with torch.no_grad():
        a = port(device_batch(batch, "cpu"))["logits"]
        b = port(device_batch(moved, "cpu"))["logits"]
    assert (a - b).abs().max() > 1e-3


def test_bf16_decode_keeps_retrieved_ids_unrounded():
    """Ids above 256 are not all bf16 numbers: the translator hands the
    ``t`` stream to the model as int64, never through a float."""
    opt = _opt(vocab_size=600, compute_dtype_decode="bfloat16", beam_size=2)
    port = build_captioner(opt, device="cpu", seed=2)
    batch = synthetic_batch(opt, 2, seed=3)
    t = opt["modality"].index("t")
    ids = np.where(batch["feats"][t] > 0, batch["feats"][t] + 253, 0)
    batch["feats"][t] = ids.astype(np.int32)
    assert (ids > 256).any() and (ids % 2 == 1).any()
    translator = get_translator(opt, device="cpu")
    feats = translator._feats({"feats": batch["feats"]})
    assert feats[t].dtype == torch.int64
    assert torch.equal(feats[t], torch.as_tensor(ids).long())
    assert feats[0].dtype == torch.bfloat16
    seen = []
    served = translator.serving_model(port)
    hook = served.pointer.register_forward_hook(
        lambda m, args, kwargs, out: seen.append(kwargs["ret_input_ids"]),
        with_kwargs=True)
    try:
        hyps, _ = translator.translate_batch(port, {"feats": batch["feats"]})
    finally:
        hook.remove()
    assert len(hyps) == 2 and seen
    want = torch.as_tensor(ids).long().repeat_interleave(2, dim=0)
    assert all(torch.equal(s, want) for s in seen)
