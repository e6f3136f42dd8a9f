"""The long-key slice as a whole: ``feats: SwinBERTDense`` configurations
(1568 dense motion patches, so more than 512 cross-attention keys, which
turns the flash attention on for the KV-cached decode step) in the port
against the JAX package on the same weights and inputs, at test size.

Tasks ``CARE`` (concept stack, hybrid bias: the kernel's bias branch) and
``Base`` (no bias), a short-key configuration with ``use_pallas_attention:
True``, and one with ``RPE``. Full-forward logits within 2e-4, the KV step
equal to the full forward (which always runs the dense attention),
``translate_batch`` token-identical with scores within 1e-4, and one flash
forward per decoder layer per beam step. On the CPU the JAX package's flash
dispatch falls through to its dense path, so its side is built with
``use_pallas_attention: False``; the port runs the flash function's plain
version.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from care_tpu import constants
from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu.training.losses import Criterion as JaxCriterion
from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models.layers import compute_hybrid_length
from care_tpu_torch.models.weights import grads_to_jax, params_from_jax
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.training.losses import Criterion
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_batch, synthetic_feats, tensors,
                                to_numpy)

TOL = 2e-4
NO_DROPOUT = {"hidden_dropout_prob": 0.0, "encoder_dropout_prob": 0.0,
              "attention_probs_dropout_prob": 0.0}


def long_key_opt(task: str, **extra) -> dict:
    """``--method Transformer --task <task> --feats SwinBERTDense`` on
    MSRVTT ``ami``, narrow: 4 frames of audio and image, 1568 rows of
    motion."""
    opt = get_opt({"dataset": "MSRVTT", "method": "Transformer", "task": task,
                   "feats": "SwinBERTDense", "modality": "ami",
                   "decoder_modality_flags": "VA",
                   "predictor_modality_flags": "VAT", "vocab_size": 40},
                  read_vocab=False, resolve_paths=False)
    opt.update(max_len=8, n_frames=4, dim_hidden=32, intermediate_size=64,
               num_attention_heads=4, attribute_prediction_k=16,
               use_attr_topk=4, retrieval_topk=4, beam_size=3,
               dim_a=6, dim_m=5, dim_i=7, dim_r=6, **extra)
    return opt


def rpe_opt() -> dict:
    """Short keys (``Base``, two streams of 6 frames), relative-position
    biases in both attentions, the flash switch forced on."""
    opt = get_opt({"dataset": "MSRVTT", "method": "Transformer",
                   "task": "Base", "feats": "ViT", "modality": "mi",
                   "vocab_size": 40}, read_vocab=False, resolve_paths=False)
    opt.update(max_len=8, n_frames=6, dim_hidden=32, intermediate_size=64,
               num_attention_heads=4, beam_size=3, dim_m=5, dim_i=7,
               RPE=True, max_relative_position=3, use_pallas_attention=True)
    return opt


def _short_key_flash_opt() -> dict:
    return dict(flagship_small_opt(vocab_size=40), use_pallas_attention=True,
                beam_size=3)


CONFIGS = {"long-CARE": lambda: long_key_opt("CARE"),
           "long-Base": lambda: long_key_opt("Base"),
           "short-forced": _short_key_flash_opt,
           "short-RPE": rpe_opt}
_pairs = {}


def _pair(name):
    """(opt, jax model, jax variables, port model), built once per
    configuration. The head's EOS column is tied to a frequent token's, so
    that beams finish at several lengths."""
    if name not in _pairs:
        opt = CONFIGS[name]()
        jmodel, variables, port = flagship_pair(
            opt, seed=len(name), jax_opt=dict(opt, use_pallas_attention=False))
        kernel = variables["params"]["cls_head"]["tgt_word_prj"]["kernel"]
        kernel[:, constants.EOS] = 0.8 * kernel[:, 17]
        params_from_jax(port, variables["params"])
        _pairs[name] = (opt, jmodel, variables, port)
    return _pairs[name]


def _flash_forwards() -> int:
    return fa.fwd_launches + fa.plain_forward_calls


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_the_flash_switch_follows_the_jax_rule(name):
    opt, _, _, port = _pair(name)
    keys = compute_hybrid_length(opt)
    assert (keys >= 512) == name.startswith("long")
    for layer in port.decoder.layers:
        assert layer.inter_attention.use_flash
        assert not layer.intra_attention.use_flash
    if name == "long-CARE":
        assert keys == 4 * 3 + 4 - 4 + 1568
        bias = port.decoder.layer_0.inter_attention.hybrid_bias
        assert tuple(bias.shape) == (4, keys)
    if name == "long-Base":
        assert port.decoder.layer_0.inter_attention.hybrid_bias is None


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_full_forward_logits_match_jax(name):
    opt, jmodel, variables, port = _pair(name)
    batch = synthetic_batch(opt, 3, seed=5)
    batch["input_ids"][0, -2:] = constants.PAD
    want = jmodel.apply(variables, batch, deterministic=True)["logits"]
    before = _flash_forwards()
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL)
    # the full forward returns probabilities: always the dense attention
    assert _flash_forwards() == before


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_kv_step_matches_full_forward_and_jax_step(name):
    """Teacher-force one sequence through the KV-cached step (flash cross
    attention) and through the full forward (dense), and through the JAX
    package's ``decode_step``."""
    opt, jmodel, variables, port = _pair(name)
    feats = synthetic_feats(opt, 2, seed=11)
    rs = np.random.RandomState(12)
    seq = rs.randint(6, opt["vocab_size"], (2, opt["max_len"] - 1))
    seq[:, 0] = constants.BOS
    ids = torch.as_tensor(seq)
    layers = opt["num_hidden_layers_decoder"]
    before = _flash_forwards()
    with torch.no_grad():
        inputs = port.prepare_inputs_for_decoder(
            port.encoding_phase(tensors(feats)), {})
        full = port.decoding_phase(ids, inputs)["logits"]
        assert _flash_forwards() == before
        state = port.init_decode_state(inputs, opt["max_len"])
        steps = []
        for t in range(seq.shape[1]):
            logits, state, _ = port.decode_step(ids[:, t], t, state)
            steps.append(logits)
    kv = torch.stack(steps, dim=1).numpy()
    assert _flash_forwards() - before == seq.shape[1] * layers
    np.testing.assert_allclose(kv, full.numpy(), rtol=0, atol=TOL)

    enc = jmodel.apply(variables, feats, method=JaxCaptioner.encoding_phase)
    jin = jmodel.apply(variables, enc, {},
                       method=JaxCaptioner.prepare_inputs_for_decoder)
    jstate = jmodel.apply(variables, jin, opt["max_len"],
                          method=JaxCaptioner.init_decode_state)
    want = []
    for t in range(seq.shape[1]):
        logits, jstate, _ = jmodel.apply(
            variables, jnp.asarray(seq[:, t]), jnp.asarray(t), jstate, jin,
            method=JaxCaptioner.decode_step)
        want.append(np.asarray(logits))
    np.testing.assert_allclose(kv, np.stack(want, axis=1), rtol=0, atol=TOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_translate_batch_matches_jax_and_counts_flash_forwards(name):
    """Token-identical hypotheses, scores within 1e-4, and one flash forward
    per decoder layer per beam step (the kernel's wrapper on a card, the
    plain version here)."""
    opt, jmodel, variables, port = _pair(name)
    feats = synthetic_feats(opt, 3, seed=21)
    want_h, want_s = jax_get_translator(
        dict(opt, use_pallas_attention=False)).translate_batch(
            [(jmodel, variables)], {"feats": feats})
    translator = get_translator(opt, device="cpu")
    before = _flash_forwards()
    got_h, got_s = translator.translate_batch(port, {"feats": feats})
    assert got_h == want_h
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    assert translator.beam_steps > 0
    assert _flash_forwards() - before == (
        translator.beam_steps * opt["num_hidden_layers_decoder"])
    assert fa.fwd_launches == 0           # no card here: no kernel launch


def test_two_decoder_layers_launch_twice_per_step():
    opt = long_key_opt("Base", num_hidden_layers_decoder=2)
    _, _, port = flagship_pair(opt, seed=2,
                               jax_opt=dict(opt, use_pallas_attention=False))
    translator = get_translator(opt, device="cpu")
    before = _flash_forwards()
    translator.translate_batch(port, {"feats": synthetic_feats(opt, 2, 3)})
    assert _flash_forwards() - before == 2 * translator.beam_steps


def test_use_pallas_attention_false_keeps_the_dense_step():
    """The same weights with the switch off: no flash forward, and the same
    hypotheses as with it on."""
    opt = long_key_opt("CARE")
    dense_opt = dict(opt, use_pallas_attention=False)
    _, _, flash_port = flagship_pair(opt, seed=7, jax_opt=dense_opt)
    _, _, dense_port = flagship_pair(dense_opt, seed=7)
    assert not dense_port.decoder.layer_0.inter_attention.use_flash
    batch = {"feats": synthetic_feats(opt, 2, seed=31)}
    before = _flash_forwards()
    hyps, scores = get_translator(dense_opt, device="cpu").translate_batch(
        dense_port, batch)
    assert _flash_forwards() == before
    want_h, want_s = get_translator(opt, device="cpu").translate_batch(
        flash_port, batch)
    assert _flash_forwards() > before
    assert hyps == want_h
    np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-5)


@pytest.mark.parametrize("task", ["CARE", "Base"])
def test_first_training_step_matches_jax(task):
    """Loss and every gradient leaf of the long-key configuration; training
    returns probabilities, so it runs the dense attention at any length."""
    opt = long_key_opt(task, **NO_DROPOUT)
    jopt = dict(opt, use_pallas_attention=False)
    batch = synthetic_batch(opt, 3, seed=41)
    jmodel, variables, port = flagship_pair(opt, seed=4, jax_opt=jopt)
    jcrit = JaxCriterion(jopt)

    def loss_fn(p):
        jb = jax.tree.map(jnp.asarray, batch)
        outputs = jmodel.apply({"params": p}, jb, deterministic=True,
                               collect_aux=False)
        return jcrit({**outputs, **jb})[0]

    want_loss, want_grads = jax.value_and_grad(loss_fn)(variables["params"])
    before = _flash_forwards()
    port.train()
    tb = device_batch(batch, "cpu")
    total, _, _ = Criterion(opt)({**port(tb), **tb})
    total.backward()
    assert _flash_forwards() == before
    np.testing.assert_allclose(total.item(), float(want_loss), rtol=2e-5)
    got = _leaves(grads_to_jax(port))
    want = _leaves(to_numpy(want_grads))
    assert sorted(got) == sorted(want)
    for path in want:
        np.testing.assert_allclose(got[path], want[path], rtol=1e-3,
                                   atol=1e-6, err_msg=path)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out
