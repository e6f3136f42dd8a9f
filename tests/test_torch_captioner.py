"""The port's Captioner (``care_tpu_torch/models/framework.py``) against the
JAX package's on the same weights: full-forward logits, the KV-cached
decode step against the full forward (as ``tests/test_decode_equivalence``
does for the flagship's ``emb_concat`` mode), the beam-grouped cache
layout, and the weight carry-over of ``models/weights.py``. Tolerance 2e-4,
the JAX suite's logit tolerance.
"""

import copy

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from care_tpu import constants
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu_torch.decoding.translator import auto_enlarge
from care_tpu_torch.models import build_captioner
from care_tpu_torch.models.weights import params_from_jax

from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_feats, tensors)

TOL = 2e-4


def _token_seq(opt, B, seed, with_pad=False):
    rs = np.random.RandomState(seed)
    seq = rs.randint(6, opt["vocab_size"], (B, opt["max_len"] - 1))
    seq[:, 0] = constants.BOS
    if with_pad:
        seq[0, -3:] = constants.PAD
    return seq


@pytest.fixture(scope="module")
def flagship():
    opt = flagship_small_opt()
    return (opt,) + flagship_pair(opt)


def test_full_forward_logits_match_jax(flagship):
    opt, jmodel, variables, port = flagship
    feats = synthetic_feats(opt, 3, seed=5)
    ids = _token_seq(opt, 3, seed=6, with_pad=True)
    want = jmodel.apply(variables, {"feats": feats, "input_ids": ids},
                        deterministic=True)["logits"]
    with torch.no_grad():
        got = port({"feats": tensors(feats),
                    "input_ids": torch.as_tensor(ids)})["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)


def _kv_logits(port, inputs, seq, max_len, beam_size=1):
    state = port.init_decode_state(inputs, max_len, beam_size=beam_size)
    out = []
    for t in range(seq.shape[1]):
        logits, state, _ = port.decode_step(seq[:, t], t, state)
        out.append(logits)
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("num_layers", [1, 2])
def test_kv_decode_matches_full_forward(num_layers):
    """Teacher-force one token sequence through the KV-cached step and
    through the full forward; per-step next-token logits agree."""
    opt = flagship_small_opt()
    opt["num_hidden_layers_decoder"] = num_layers
    _, _, port = flagship_pair(opt, seed=num_layers)
    feats = tensors(synthetic_feats(opt, 3, seed=11))
    seq = torch.as_tensor(_token_seq(opt, 3, seed=5))
    with torch.no_grad():
        inputs = port.prepare_inputs_for_decoder(port.encoding_phase(feats),
                                                 {})
        full = torch.stack(
            [port.decoding_phase(seq[:, :t], inputs,
                                 last_time_step_logits=True)["logits"]
             for t in range(1, seq.shape[1] + 1)], dim=1)
        kv = _kv_logits(port, inputs, seq, opt["max_len"])
    np.testing.assert_allclose(kv.numpy(), full.numpy(), rtol=0, atol=TOL)


def test_kv_decode_matches_jax_decode_step(flagship):
    opt, jmodel, variables, port = flagship
    feats = synthetic_feats(opt, 2, seed=12)
    seq = _token_seq(opt, 2, seed=13)
    enc = jmodel.apply(variables, feats, method=JaxCaptioner.encoding_phase)
    inputs = jmodel.apply(variables, enc, {},
                          method=JaxCaptioner.prepare_inputs_for_decoder)
    state = jmodel.apply(variables, inputs, opt["max_len"],
                         method=JaxCaptioner.init_decode_state)
    want = []
    for t in range(seq.shape[1]):
        logits, state, _ = jmodel.apply(
            variables, jnp.asarray(seq[:, t]), jnp.asarray(t), state, inputs,
            method=JaxCaptioner.decode_step)
        want.append(np.asarray(logits))
    with torch.no_grad():
        pin = port.prepare_inputs_for_decoder(
            port.encoding_phase(tensors(feats)), {})
        got = _kv_logits(port, pin, torch.as_tensor(seq), opt["max_len"])
    np.testing.assert_allclose(got.numpy(), np.stack(want, axis=1), rtol=0,
                               atol=TOL)


def test_beam_grouped_cache_matches_enlarged(flagship):
    """Cross K/V at [B] rows with the beam folded into the queries equals
    the decode over inputs enlarged to [B*beam] rows."""
    opt, _, _, port = flagship
    beam = 3
    feats = tensors(synthetic_feats(opt, 2, seed=14))
    seq = torch.as_tensor(_token_seq(opt, 2 * beam, seed=15))
    with torch.no_grad():
        inputs = port.prepare_inputs_for_decoder(port.encoding_phase(feats),
                                                 {})
        grouped = _kv_logits(port, inputs, seq, opt["max_len"],
                             beam_size=beam)
        enlarged = _kv_logits(port, auto_enlarge(inputs, beam), seq,
                              opt["max_len"])
    np.testing.assert_allclose(grouped.numpy(), enlarged.numpy(), rtol=0,
                               atol=1e-5)


def test_params_from_jax_fills_every_parameter(flagship):
    opt, _, variables, port = flagship
    params = variables["params"]
    n_jax = sum(np.size(x) for x in _leaves(params))
    assert n_jax == sum(p.numel() for p in port.parameters())
    kernel = params["cls_head"]["tgt_word_prj"]["kernel"]
    np.testing.assert_array_equal(
        port.cls_head.tgt_word_prj.weight.detach().numpy(), kernel.T)

    # copies, never aliases: changing the source leaves the port as it was
    fresh = build_captioner(opt, device="cpu", seed=1)
    src = copy.deepcopy(params)
    params_from_jax(fresh, src)
    before = fresh.decoder.embedding.word_embeddings.detach().clone()
    src["decoder"]["embedding"]["word_embeddings"] += 1.0
    assert torch.equal(fresh.decoder.embedding.word_embeddings, before)

    extra = copy.deepcopy(params)
    extra["decoder"]["unused"] = np.zeros(3, np.float32)
    with pytest.raises(KeyError, match="unused"):
        params_from_jax(fresh, extra)
    missing = copy.deepcopy(params)
    del missing["decoder"]["layer_0"]["inter_attention"]["hybrid_bias"]
    with pytest.raises(KeyError, match="hybrid_bias"):
        params_from_jax(fresh, missing)
    wrong = copy.deepcopy(params)
    wrong["cls_head"]["tgt_word_prj"]["kernel"] = kernel[:, :-1]
    with pytest.raises(ValueError, match="shape"):
        params_from_jax(fresh, wrong)


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v
