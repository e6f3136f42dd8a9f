"""The concept-attention sublayer (LSG ``L1``: ``use_attr_type`` ``_att`` and
``emb_att``) in its three placements against the JAX package, and the
KV-cached decode against the full forward in every G-LSG mode of
``tests/test_decode_equivalence.py``.

Test size (``torch_paper_grid.tiny_opt``: 4 heads of width 4, 16
concepts of which 4 are used), two decoder layers, f32, dropout off. Logits
and attention probabilities within 2e-4 (the JAX suite's bound), beams
token-identical with scores within 1e-4, the port's KV-cached step within
2e-4 of the JAX package's full forward at every position.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (decoder_inputs, flagship_pair,
                                per_step_logits_jax, per_step_logits_port,
                                synthetic_batch, token_sequence)
from torch_paper_grid import tiny_opt

CONCEPT = dict(dataset="MSRVTT", arch="base", method="Transformer",
               task="Concept", feats="ViT", decoder_modality_flags="VA",
               predictor_modality_flags="VAT")


def _opt(**final):
    return tiny_opt(dict(CONCEPT, final_overrides=dict(
        num_hidden_layers_decoder=2, **final)))


@pytest.mark.parametrize("use_attr_type", ["_att", "emb_att"])
@pytest.mark.parametrize("pos", ["cross2attr", "attr2cross", "parallel"])
def test_placement_matches_jax(pos, use_attr_type):
    opt = _opt(use_attr_type=use_attr_type, attr_layer_pos=pos)
    jmodel, variables, port = flagship_pair(opt, seed=2)
    assert port.decoder.layer_0.has_attr_attention
    assert (port.decoder.layer_1.LayerNorm is not None) == (pos == "parallel")
    batch = synthetic_batch(opt, 3, seed=3)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    for key in ("logits", "attention_probs", "context", "text_context",
                "cross_embs", "sentence_embs"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    assert len(got["attr_attention_probs"]) == 2
    for g, w in zip(got["attr_attention_probs"],
                    want["attr_attention_probs"]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=2e-4)

    # the KV-cached step over the concept K/V at [B] against the full
    # forward, both packages
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    seq = token_sequence(opt, 3, seed=4)
    full = per_step_logits_jax(jmodel, variables, jinputs, jnp.asarray(seq))
    kv = per_step_logits_port(port, pinputs, torch.as_tensor(seq).long(),
                              max_len=opt["max_len"])
    np.testing.assert_allclose(kv, full, rtol=0, atol=2e-4)

    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": batch["feats"]})
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": batch["feats"]})
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)


MODES = [
    ("emb_concat", {}),                                   # CARE G1Lc
    ("_att", {"add_hybrid_attention_bias": False}),       # CABase G0L1
    ("pp_emb_concat", {}),                                # GpLc
    ("_prefix", {"add_hybrid_attention_bias": False}),    # prefix-LSG
    ("emb_att", {"add_hybrid_attention_bias": False}),    # G1L1
]


@pytest.mark.parametrize("use_attr_type,extra", MODES)
def test_kv_logits_match_jax_full_forward(use_attr_type, extra):
    """``tests/test_decode_equivalence.py``'s modes: the port's KV-cached
    step (the concept prefix prefilled into the cache for ``pp_emb`` and
    ``prefix``) and the port's full forward against the JAX package's full
    forward, position by position."""
    opt = tiny_opt(dict(
        task="CARE", dataset="MSRVTT", method="Transformer", feats="ViT",
        decoder_modality_flags="V", predictor_modality_flags="V",
        final_overrides=dict(use_attr_type=use_attr_type,
                             num_hidden_layers_decoder=2, **extra)))
    assert opt["use_attr_type"] == use_attr_type
    jmodel, variables, port = flagship_pair(opt, seed=11)
    batch = synthetic_batch(opt, 3, seed=12)
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    seq = token_sequence(opt, 3, seed=5)
    want = per_step_logits_jax(jmodel, variables, jinputs, jnp.asarray(seq))
    tseq = torch.as_tensor(seq).long()
    np.testing.assert_allclose(per_step_logits_port(port, pinputs, tseq),
                               want, rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        per_step_logits_port(port, pinputs, tseq, max_len=opt["max_len"]),
        want, rtol=0, atol=2e-4)


def test_parallel_cross_attention_takes_flash():
    """In the ``parallel`` placement the cross attention (no LN, no
    residual) takes the flash function in every step of every layer, the
    concept attention never; the beams equal the JAX package's with its
    flash dispatch off."""
    opt = _opt(use_attr_type="emb_att", attr_layer_pos="parallel",
               use_pallas_attention=True)
    jmodel, variables, port = flagship_pair(
        opt, seed=6, jax_opt=dict(opt, use_pallas_attention=False))
    assert port.decoder.layer_0.inter_attention.use_flash
    assert not port.decoder.layer_0.attr_attention.use_flash
    batch = synthetic_batch(opt, 2, seed=7)
    want_h, want_s = jax_get_translator(
        dict(opt, use_pallas_attention=False)).translate_batch(
            [(jmodel, variables)], {"feats": batch["feats"]})
    translator = get_translator(opt, device="cpu")
    before = fa.plain_forward_calls
    got_h, got_s = translator.translate_batch(port,
                                              {"feats": batch["feats"]})
    assert fa.plain_forward_calls - before == 2 * translator.beam_steps
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
