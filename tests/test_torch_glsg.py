"""The other G-LSG families and decoder inputs against the JAX package:

* the GSG prefix token ``pp_emb`` (``Gp*`` flags, the biased
  ``semantic2hidden``) with each LSG mode, and the LSG concept prefix
  ``_prefix`` (the prefix-mask surgery; the decode prefills the prefix
  into the self-attention cache);
* category embeddings (``with_category``, MSRVTT's), through the batch's
  ``category`` in training and serving;
* pretrained word embeddings read from a local ``.npy`` file (this test
  writes its own), projected by ``w2h`` when narrower than the model;
* ``TAP_pos`` / ``TAP_ln`` on the embeddings the decoder-side concept
  flags read;
* the full forward's aux dict (``collect_aux``).

Test size, f32, dropout off. Logits and aux entries within 2e-4, the
KV-cached step within 2e-4 of the JAX package's KV-cached step, beams
token-identical. The JAX package's step embeds the words of the prefix
modes without the GSG vector (the ``emb_prefix`` mode's full forward adds
it); the port does as it does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.training.trainer import device_batch

from test_torch_support import (decoder_inputs, flagship_pair,
                                per_step_logits_jax_kv,
                                per_step_logits_port,
                                synthetic_batch, token_sequence)
from torch_paper_grid import tiny_opt

CONCEPT = dict(dataset="MSRVTT", arch="base", method="Transformer",
               task="Concept", feats="ViT", decoder_modality_flags="VA",
               predictor_modality_flags="VAT")


def _held(opt, seed, aux_keys=("logits",)):
    jmodel, variables, port = flagship_pair(opt, seed=seed)
    batch = synthetic_batch(opt, 3, seed=seed + 1)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    for key in aux_keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-4, err_msg=key)
    jinputs, pinputs = decoder_inputs(jmodel, variables, port, batch)
    seq = token_sequence(opt, 3, seed=seed + 2)
    np.testing.assert_allclose(
        per_step_logits_port(port, pinputs, torch.as_tensor(seq).long(),
                             max_len=opt["max_len"]),
        per_step_logits_jax_kv(jmodel, variables, jinputs, jnp.asarray(seq),
                               opt["max_len"]),
        rtol=0, atol=2e-4)
    serve = {k: batch[k] for k in ("feats", "category") if k in batch}
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], serve)
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, serve)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=1e-4)
    return port, want, got


@pytest.mark.parametrize("flags", ["GpL0", "GpLc", "GpL1"])
def test_pp_emb_matches_jax(flags):
    opt = tiny_opt(dict(CONCEPT, use_attr_flags=flags))
    assert opt["use_attr_type"].startswith("pp_emb")
    port, _, _ = _held(opt, seed=1)
    assert port.predictor.SemanticContainer.semantic2hidden.bias is not None
    assert port.decoder.prefix_len == 1


@pytest.mark.parametrize("use_attr_type", ["_prefix", "emb_prefix"])
def test_concept_prefix_matches_jax(use_attr_type):
    opt = tiny_opt(dict(CONCEPT, use_attr_flags="G1Lc", final_overrides={
        "use_attr_type": use_attr_type, "num_hidden_layers_decoder": 2}))
    port, _, got = _held(opt, seed=4, aux_keys=("logits", "input_embs"))
    assert port.decoder.prefix_len == opt["use_attr_topk"]
    # the hidden states carry the prefix slots; the logits too
    assert got["hidden_states"].shape[1] == (opt["max_len"] - 1
                                             + opt["use_attr_topk"])


def test_category_embeddings_match_jax():
    opt = tiny_opt(dict(CONCEPT, use_attr_flags="G1Lc",
                        final_overrides={"with_category": True}))
    port, _, _ = _held(opt, seed=7)
    assert port.decoder.embedding.category_embeddings.shape == (
        opt["num_category"], opt["dim_hidden"])


@pytest.mark.parametrize("width", ["narrower", "same"])
def test_pretrained_word_embeddings_match_jax(width, tmp_path):
    opt = tiny_opt(dict(CONCEPT, use_attr_flags="G1Lc"))
    dim = opt["dim_hidden"] // 2 if width == "narrower" else opt["dim_hidden"]
    table = np.random.RandomState(8).randn(opt["vocab_size"], dim)
    path = str(tmp_path / "embs.npy")
    np.save(path, table.astype(np.float32))
    opt["pretrained_embs_path"] = path
    port, _, _ = _held(opt, seed=8)
    assert (port.decoder.embedding.w2h is not None) == (width == "narrower")


def test_tap_post_processing_matches_jax():
    """``TAP_pos`` and ``TAP_ln`` on the decoder's sentence and concept-word
    embeddings (the ``S`` and ``A`` flags' inputs)."""
    opt = tiny_opt(dict(CONCEPT, use_attr_flags="G1Lc", final_overrides={
        "TAP_pos": True, "TAP_ln": True}))
    rs = np.random.RandomState(9)
    attr_ids = rs.randint(6, opt["vocab_size"], (3, 5)).astype(np.int32)
    jmodel, variables, port = flagship_pair(opt, seed=9)
    assert port.decoder.TPP.PE is not None and port.decoder.TPP.LN
    batch = dict(synthetic_batch(opt, 3, seed=10), attr_input_ids=attr_ids)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    for key in ("sentence_embs", "attr_embs", "logits"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=2e-4, err_msg=key)


def test_aux_dict_matches_jax():
    """``collect_aux``: the same entries as the JAX package's forward, each
    within 2e-4; without it only the hidden states and the logits."""
    opt = tiny_opt(dict(CONCEPT, use_attr_flags="G1L1", final_overrides={
        "num_hidden_layers_decoder": 2, "attr_layer_pos": "attr2cross"}))
    jmodel, variables, port = flagship_pair(opt, seed=11)
    batch = synthetic_batch(opt, 3, seed=12)
    want = jmodel.apply(variables, batch, deterministic=True)
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))
    decoder_keys = {"all_hidden_states", "all_intra_attentions",
                    "all_inter_attentions", "attention_probs", "context",
                    "text_context", "self_embs", "cross_embs", "input_embs",
                    "input_embs_exclude_bos", "sentence_embs",
                    "attr_attention_probs"}
    assert decoder_keys <= set(want) and decoder_keys <= set(got)
    for key in sorted(decoder_keys):
        w, g = want[key], got[key]
        if isinstance(w, (list, tuple)):
            assert len(g) == len(w), key
        else:
            w, g = [w], [g]
        for a, b in zip(g, w):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=2e-4, err_msg=key)
    with torch.no_grad():
        lean = port(device_batch(batch, "cpu"), collect_aux=False)
    assert not decoder_keys & set(lean)
    np.testing.assert_allclose(lean["logits"].numpy(),
                               got["logits"].numpy(), rtol=0, atol=0)
