"""Fused-K, grouped and half-precision decoding of the port against per-batch
decoding and against the JAX package (``tests/test_pipelined_decode.py``'s
AR cases), on the same weights (``params_from_jax``), dropout off.

* ``translate_batches_grouped`` with all the batches in flight equals
  per-batch ``translate_batch``, which equals the JAX package's beams
  (token-identical, scores 1e-4);
* ``translate_batches_grouped`` decodes an aux mismatch, a ragged tail
  and short batches inside the stream at their own rows, one decode a
  batch (hypotheses and scores ``==`` the per-batch decode), and keeps
  input order;
* ``Trainer.validate`` with ``eval_fused_k`` 4 gives the COCO dict of 1
  (``==``), and ``translate.run_eval --fused_k`` the predictions and scores
  of the pipelined path;
* half precision: the dtype as the string ``"bfloat16"`` or
  ``torch.bfloat16``; ``decode_head_f32`` keeps ``cls_head`` f32; every
  module computes in the dtype the JAX package's flax modules use (the
  flagship's f32 concept vector makes its decoder f32, the ``Base`` task's
  decoder runs bf16); teacher-forced decode-step log-probs within
  a bf16 tolerance of the JAX package's bf16 decode, and token-identical
  beams where the flagship's head is scaled so that the logits are sharp;
* the mixed-dtype rule of the fused head and of flash attention.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu.decoding.translator import _cast_variables as jax_cast
from care_tpu.models.framework import Captioner as JaxCaptioner
from care_tpu.ops.fused_head_topk import (
    fused_head_beam_topk as jax_fused_head)
from care_tpu_torch import translate as port_translate
from care_tpu_torch.data import get_loader
from care_tpu_torch.data.corpus import write_synthetic_dataset
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models.weights import params_from_jax
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops.fused_head_topk import fused_head_beam_topk
from care_tpu_torch.training import Trainer
from helpers import tiny_opt
from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_feats)

# bf16 decode of the port against the JAX package's on the CPU, where XLA
# keeps excess precision in bf16 (ROADMAP.md Queue 3) while torch rounds
# each op's output: the flagship's decoder runs f32 on bf16 weights and its
# per-step log-probs agree to BF16_LOGP_TOL; the ``Base`` decoder runs bf16
# and agrees to BF16_LOGP_REL of the step's largest |log-prob| (about five
# bf16 roundings at that scale). f32 decodes agree to 2e-4.
BF16_LOGP_TOL = 5e-2
BF16_LOGP_REL = 2e-2


def _bf16_tol(task, logp):
    if task == "CARE":
        return BF16_LOGP_TOL
    return BF16_LOGP_REL * float(np.abs(logp).max())
COCO_KEYS = ("Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
             "CIDEr", "Sum")


def _base_opt(**extra):
    return tiny_opt(vocab_size=40, beam_size=3, topk=2, **extra)


def _batches(opt, sizes, seed=1):
    return [{"feats": synthetic_feats(opt, n, seed + i)}
            for i, n in enumerate(sizes)]


def _assert_decode_equal(got, want, tol=1e-5):
    """Token-identical hypotheses; scores to ``tol``."""
    assert len(got) == len(want)
    for (g_h, g_s), (w_h, w_s) in zip(got, want):
        assert g_h == w_h
        assert len(g_s) == len(w_s)
        for g, w in zip(g_s, w_s):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol)


def _bf16_pair(task, seed):
    """(opt, JAX model, variables, port) for the bf16 comparisons. On the
    flagship the concept detector's scores are spread by a bias ramp, so
    that its top-k concept slots are not near-ties that bf16 rounding
    flips (random weights saturate the noisy-OR near 1 otherwise)."""
    opt = (flagship_small_opt(vocab_size=40) if task == "CARE"
           else _base_opt())
    jmodel, variables, port = flagship_pair(opt, seed=seed)
    if task == "CARE":
        prj = variables["params"]["predictor"]["Predictor_attribute"][
            "attribute_heads"]["prj"]
        k = prj["bias"].shape[0]
        prj["kernel"] = prj["kernel"] * 0.1
        prj["bias"] = np.random.RandomState(seed).permutation(
            np.linspace(-9.0, -3.0, k)).astype(np.float32)
        params_from_jax(port, variables["params"])
    return opt, jmodel, variables, port


def _spy_dispatch_rows(tr):
    """The row count of every decode ``tr`` dispatches from now on."""
    rows = []
    inner = tr.dispatch

    def dispatch(models, batch):
        rows.append(int(batch["feats"][0].shape[0]))
        return inner(models, batch)

    tr.dispatch = dispatch
    return rows


@pytest.fixture(scope="module")
def base_pair():
    opt = _base_opt()
    jmodel, variables, port = flagship_pair(opt, seed=3)
    return opt, jmodel, variables, port


def test_fused_k_batches_equal_sequential_and_jax(base_pair):
    opt, jmodel, variables, port = base_pair
    tr = get_translator(opt, device="cpu")
    batches = _batches(opt, [3, 3, 3])
    seq = [tr.translate_batch(port, b) for b in batches]
    assert [out for _, out in tr.translate_batches_grouped(
        [port], enumerate(batches), len(batches))] == seq
    jtr = jax_get_translator(opt)
    want = [jtr.translate_batch([(jmodel, variables)], b) for b in batches]
    _assert_decode_equal(seq, want, tol=1e-4)


def test_grouped_decode_splits_on_aux_mismatch(base_pair):
    opt, _, _, port = base_pair
    tr = get_translator(opt, device="cpu")
    stream = _batches(opt, [3, 3, 3])
    stream[2] = {**stream[2], "category": np.zeros((3, 1), np.int64)}
    seq = [tr.translate_batch(port, b) for b in stream]
    rows = _spy_dispatch_rows(tr)
    grouped = list(tr.translate_batches_grouped(
        port, ((i, b) for i, b in enumerate(stream)), fused_k=2))
    assert [tag for tag, _ in grouped] == [0, 1, 2]
    assert [out for _, out in grouped] == seq
    # one decode a batch, [2] (its own aux key set) among them: no decode
    # of a repeated batch to fill a group
    assert rows == [3, 3, 3]


def test_grouped_decode_ragged_tail_row_padded(base_pair):
    """A short last batch, which the JAX package row-pads into its group's
    shape, decodes at its own rows here: hypotheses and scores equal to
    its per-batch decode; the JAX package's grouped decode gives the
    same."""
    opt, jmodel, variables, port = base_pair
    tr = get_translator(opt, device="cpu")
    stream = _batches(opt, [3, 3, 3, 3, 2])
    seq = [tr.translate_batch(port, b) for b in stream]
    rows = _spy_dispatch_rows(tr)
    grouped = list(tr.translate_batches_grouped(
        port, ((i, b) for i, b in enumerate(stream)), fused_k=2))
    assert [tag for tag, _ in grouped] == [0, 1, 2, 3, 4]
    got = [out for _, out in grouped]
    assert got == seq
    assert rows == [3, 3, 3, 3, 2]
    assert len(got[4][0]) == 2
    jtr = jax_get_translator(opt)
    want = [out for _, out in jtr.translate_batches_grouped(
        [(jmodel, variables)], ((i, b) for i, b in enumerate(stream)),
        fused_k=2)]
    _assert_decode_equal(got, want, tol=1e-4)


def test_grouped_decode_mixed_rows_interleaved(base_pair):
    """Batches of mixed row counts, numpy arrays and tensors alike, decode
    at their own rows, in input order."""
    opt, _, _, port = base_pair
    tr = get_translator(opt, device="cpu")
    b3, b2, b4 = (_batches(opt, [n, n], seed=10 * n) for n in (3, 2, 4))
    stream = [b3[0], b2[0], b3[1], b2[1], b4[0]]
    stream[1] = {"feats": [torch.as_tensor(f) for f in stream[1]["feats"]]}
    seq = [tr.translate_batch(port, b) for b in stream]
    rows = _spy_dispatch_rows(tr)
    grouped = list(tr.translate_batches_grouped(
        port, ((i, b) for i, b in enumerate(stream)), fused_k=2))
    assert [tag for tag, _ in grouped] == [0, 1, 2, 3, 4]
    assert [out for _, out in grouped] == seq
    assert rows == [3, 2, 3, 2, 4]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("torch_fused_decode"))
    opt = flagship_small_opt()
    data_dir, paths, corpus, refs = write_synthetic_dataset(root, opt,
                                                            n_videos=30)
    return data_dir, paths, corpus, refs


def _data_opt(data, tmp_path, **extra):
    data_dir, paths, corpus, _ = data
    opt = dict(flagship_small_opt(vocab_size=len(corpus["info"]["itow"])),
               batch_size=4, eval_batch_size=2, beam_size=3,
               hidden_dropout_prob=0.0, encoder_dropout_prob=0.0,
               attention_probs_dropout_prob=0.0, **extra)
    opt["info_corpus"] = os.path.join(data_dir, "info_corpus.pkl")
    opt["reference"] = os.path.join(data_dir, "refs.pkl")
    for c, p in paths.items():
        opt[f"feats_{c}"] = [p]
    opt["checkpoint_path"] = str(tmp_path / "exps")
    return opt


def test_trainer_validate_fused_k_equals_pipelined(data, tmp_path):
    """``eval_fused_k`` 4 (grouped, through the validation bank) against 1
    (pipelined) and against the per-batch ``translate_step``: equal COCO
    dicts."""
    _, _, corpus, refs = data
    from care_tpu_torch.metrics import COCOScorer
    opt = _data_opt(data, tmp_path, eval_fused_k=4)
    val = get_loader(opt, "validate", is_validation=True, not_shuffle=True,
                     batch_size=2, pad_to_batch=True)
    assert len(val) == 3        # K clamps to 3; the last batch is ragged
    tr = Trainer(opt, train_loader=get_loader(opt, "train"), val_loader=val,
                 references=refs, vocab=corpus["info"]["itow"], device="cpu")
    tr.init_model(seed=4)
    grouped = tr.validate(0)
    steps = tr.translator.beam_steps
    assert steps > 0
    tr.opt["eval_fused_k"] = 1
    piped = tr.validate(0)
    assert tr.translator.beam_steps == 2 * steps
    tr.model.eval()
    preds = {}
    for batch in val:
        preds.update(tr._collect_preds(batch, *tr.translator.translate_batch(
            tr.model, {"feats": batch["feats"]})))
    tr.model.train()
    seq, _ = COCOScorer().score(refs, preds, list(preds))
    for k in COCO_KEYS[:-1]:
        assert grouped[k] == piped[k] == seq[k], k
    assert grouped == piped


def test_run_eval_fused_k_matches_pipelined(data, tmp_path):
    """``translate.run_eval`` with ``--fused_k`` (a ragged tail included)
    gives the predictions and scores of the pipelined path."""
    _, _, corpus, refs = data
    opt = _data_opt(data, tmp_path)
    from care_tpu_torch.models import build_captioner
    model = build_captioner(opt, device="cpu", seed=2)
    itow = corpus["info"]["itow"]

    def loader():
        return get_loader(opt, "test", not_shuffle=True, batch_size=4)

    assert len(loader().dataset) % 4 != 0
    s1, _, p1, _, n1 = port_translate.run_eval([model], opt, loader(), refs,
                                               itow, device="cpu")
    s2, _, p2, _, n2 = port_translate.run_eval([model], opt, loader(), refs,
                                               itow, fused_k=2, device="cpu")
    assert n1 == n2 == len(loader().dataset)
    assert p1 == p2
    assert s1 == s2


# ---------------------------------------------------------------------------
# half precision
# ---------------------------------------------------------------------------

def test_bf16_decode_string_dtype_and_f32_head(base_pair):
    """``compute_dtype_decode`` as the string argparse delivers or as the
    torch dtype; ``decode_head_f32`` keeps ``cls_head`` f32. Both give
    well-formed captions, and the caller's model stays f32."""
    opt, _, _, port = base_pair
    batch = _batches(opt, [3])[0]
    for dtype in ("bfloat16", torch.bfloat16):
        tr = get_translator({**opt, "compute_dtype_decode": dtype},
                            device="cpu")
        hyps, scores = tr.translate_batch(port, batch)
        assert len(hyps) == 3
        assert all(0 <= t < opt["vocab_size"] for row in hyps for t in row[0])
        assert all(np.isfinite(s) for row in scores for s in row)
        served = tr.serving_model(port)
        assert served is not port
        assert all(p.dtype == torch.bfloat16 for p in served.parameters())
    tr = get_translator({**opt, "compute_dtype_decode": "bfloat16",
                         "decode_head_f32": True}, device="cpu")
    hyps, _ = tr.translate_batch(port, batch)
    assert len(hyps) == 3
    assert all(0 <= t < opt["vocab_size"] for row in hyps for t in row[0])
    served = tr.serving_model(port)
    assert served.cls_head.tgt_word_prj.weight.dtype == torch.float32
    assert served.decoder.layer_0.ffn.dense1.weight.dtype == torch.bfloat16
    assert all(p.dtype == torch.float32 for p in port.parameters())
    # the copy is made once and again after the caller's weights change
    assert tr.serving_model(port) is served
    with torch.no_grad():
        port.cls_head.tgt_word_prj.weight.mul_(1.0)
    assert tr.serving_model(port) is not served


def _decode_step_logps(opt, jmodel, variables, port, feats, head_f32,
                       n_steps=2):
    """Log-probs of the first ``n_steps`` decode steps (BOS, then each
    row's argmax token of the JAX package's step: its greedy path), from
    the JAX package's bf16 decode and the port's, with the dtypes of the
    decoder's hidden states."""
    jv = jax_cast(variables, jnp.bfloat16, head_f32)
    jf = [jnp.asarray(f).astype(jnp.bfloat16) for f in feats]
    enc = jmodel.apply(jv, jf, method=JaxCaptioner.encoding_phase)
    inputs = jmodel.apply(jv, enc, {},
                          method=JaxCaptioner.prepare_inputs_for_decoder)
    state = jmodel.apply(jv, inputs, opt["max_len"], 1,
                         method=JaxCaptioner.init_decode_state)
    tr = get_translator({**opt, "compute_dtype_decode": "bfloat16",
                         "decode_head_f32": head_f32}, device="cpu")
    served = tr.serving_model(port)
    with torch.no_grad():
        pf = tr._feats({"feats": feats})
        penc = served.encoding_phase(pf)
        pstate = served.init_decode_state(
            served.prepare_inputs_for_decoder(penc, {}), opt["max_len"], 1)
    tokens = np.full((feats[0].shape[0],), 2)
    out = []
    for t in range(n_steps):
        jl, state = jmodel.apply(jv, jnp.asarray(tokens), t, state, inputs,
                                 method=JaxCaptioner.decode_step)[:2]
        with torch.no_grad():
            h, pstate = served.decode_step_hidden(torch.as_tensor(tokens), t,
                                                  pstate)
            pl = served.cls_head(h)
        want = np.asarray(jax.nn.log_softmax(jl.astype(jnp.float32)))
        got = torch.log_softmax(pl.float(), dim=-1).numpy()
        out.append((got, want, h.dtype))
        tokens = want.argmax(axis=-1)
    return out


@pytest.mark.parametrize("task", ["CARE", "Base"])
@pytest.mark.parametrize("head_f32", [False, True])
def test_bf16_decode_steps_match_jax(task, head_f32):
    """Teacher-forced decode steps of the bf16 copy against the JAX
    package's bf16 decode: log-probs within ``_bf16_tol``, and the
    decoder's hidden states in the JAX package's dtype (f32 on the
    flagship, whose f32 concept vector promotes the embeddings; bf16 on
    ``Base``)."""
    opt, jmodel, variables, port = _bf16_pair(task, seed=7)
    feats = synthetic_feats(opt, 3, seed=8)
    for got, want, h_dtype in _decode_step_logps(opt, jmodel, variables,
                                                 port, feats, head_f32):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=_bf16_tol(task, want))
        assert h_dtype == (torch.float32 if task == "CARE"
                           else torch.bfloat16)


def test_bf16_beams_match_jax_on_sharp_logits():
    """With the flagship's vocab head scaled by 8, every checked step's
    top-2 log-prob gap of the JAX package's bf16 decode exceeds the bf16
    tolerance, and the port's bf16 beams are token-identical to the JAX
    package's bf16 beams, their scores within that tolerance. (The
    all-bf16 ``Base`` decoder is held by its step log-probs above: on
    random weights its decodes meet near-ties below the tolerance.)"""
    opt, jmodel, variables, port = _bf16_pair("CARE", seed=11)
    opt = dict(opt, compute_dtype_decode="bfloat16")
    params = variables["params"]
    params["cls_head"]["tgt_word_prj"]["kernel"] = (
        params["cls_head"]["tgt_word_prj"]["kernel"] * 8.0)
    params_from_jax(port, params)
    feats = synthetic_feats(opt, 4, seed=12)
    for _, want, _ in _decode_step_logps(opt, jmodel, variables, port, feats,
                                         False):
        top2 = np.sort(want, axis=-1)[:, -2:]
        assert (top2[:, 1] - top2[:, 0]).min() > BF16_LOGP_TOL
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": feats})
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, {"feats": feats})
    assert got_h == want_h
    _assert_decode_equal([(got_h, got_s)], [(want_h, want_s)],
                         tol=BF16_LOGP_TOL)


def test_mixed_dtype_head_promotes_like_jax():
    """bf16 h against an f32 W (``decode_head_f32``) computes in f32 with no
    rounding of the logits: the result of the f32 head on the same h, and
    the JAX package's fused head on the same mixed operands."""
    rs = np.random.RandomState(0)
    N, K, H, V = 3, 4, 32, 300
    h = torch.as_tensor(rs.randn(N * K, H), dtype=torch.bfloat16)
    W = torch.as_tensor(rs.randn(V, H) * 0.3, dtype=torch.float32)
    scores = torch.as_tensor(rs.randn(N, K), dtype=torch.float32)
    eos = torch.zeros((N, K), dtype=torch.bool)
    got = fused_head_beam_topk(h, W, None, scores, eos, K, chunk_size=128)
    want = fused_head_beam_topk(h.float(), W, None, scores, eos, K,
                                chunk_size=128)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])
    jh = jnp.asarray(h.float().numpy()).astype(jnp.bfloat16)
    jbest, jids = jax_fused_head(jh, jnp.asarray(W.numpy().T), None,
                                 jnp.asarray(scores.numpy()),
                                 jnp.asarray(eos.numpy()), K, chunk_size=128,
                                 backend="xla")
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(jids))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(jbest), rtol=0,
                               atol=1e-5)


def test_mixed_dtype_flash_attention_promotes():
    """An f32 query against bf16 keys and values (the flagship's f32
    decoder over a bf16 cache) is attention on the promoted operands."""
    rs = np.random.RandomState(1)
    q = torch.as_tensor(rs.randn(2, 2, 5, 32), dtype=torch.float32)
    k, v = (torch.as_tensor(rs.randn(2, 2, 70, 32), dtype=torch.bfloat16)
            for _ in range(2))
    bias = torch.as_tensor(rs.randn(1, 2, 1, 70), dtype=torch.bfloat16)
    got = fa.flash_attention(q, k, v, bias=bias)
    want = fa.flash_attention(q, k.float(), v.float(), bias=bias.float())
    assert got.dtype == torch.float32
    assert torch.equal(got, want)
