"""The port's ``TranslatorNARFormer`` against the JAX package's, on the same
weights (``variables_from_jax``), f32, dropout off.

* NAB (MaskPredict) and NACF (MaskPredict with the coarse-grained template,
  Left2Right, EasyFirst), rescored by an ARB teacher: hypotheses token for
  token and log-probs within 2e-4;
* the fused-statistics path (the argmax/lse kernel's plain version on the
  CPU: one call per refinement pass and one per teacher rescoring) and the
  dense-logits path give the same decode;
* teacher rescoring through an identity vocabulary mapping and through a
  permuted one (a teacher whose vocabulary rows are permuted, reached
  through the mapping, scores as the unpermuted teacher does);
* grouped decoding (``eval_fused_k`` 4) equals batch-by-batch decoding;
* half precision (``compute_dtype_decode: bfloat16``) against the JAX
  package's bf16 decode, log-probs within ``BF16_LOGP_TOL`` of
  ``tests/test_torch_fused_decode.py``;
* the length beam's ties, the f32 index of ``nar_resample`` and the input
  enhancements other than the default.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.decoding import TranslatorNARFormer, get_translator
from care_tpu_torch.ops import fused_head_topk as fht

from test_torch_fused_decode import BF16_LOGP_TOL
from test_torch_support import flagship_pair, synthetic_batch
from torch_paper_grid import VERS_MSRVTT, tiny_opt

STUDENTS = {"NAB": dict(VERS_MSRVTT, method="NAB", task="Base"),
            "NACF": dict(VERS_MSRVTT, method="NACF", task="Base",
                         with_teacher_during_training=True)}


@pytest.fixture(scope="module")
def teacher():
    opt = tiny_opt(dict(VERS_MSRVTT, method="ARB", task="Base"))
    jmodel, variables, port = flagship_pair(opt, seed=7)
    return (jmodel, variables), port


@pytest.fixture(scope="module")
def students():
    out = {}
    for name, overrides in STUDENTS.items():
        opt = tiny_opt(overrides)
        jmodel, variables, port = flagship_pair(opt, seed=3)
        out[name] = (opt, (jmodel, variables), port)
    return out


def _feats(opt, n, seed):
    return {"feats": synthetic_batch(opt, n, seed)["feats"]}


@pytest.mark.parametrize("student,extra", [
    ("NAB", {"paradigm": "mp"}),
    ("NACF", {"paradigm": "mp", "masking_decision": True}),
    ("NACF", {"paradigm": "l2r", "q": 2}),
    ("NACF", {"paradigm": "ef"})],
    ids=["NAB-mp", "NACF-mp-md", "NACF-l2r", "NACF-ef"])
def test_nar_decode_matches_jax(students, teacher, student, extra):
    opt, jpair, port = students[student]
    opt = dict(opt, **extra)
    feats = _feats(opt, 3, seed=4)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [jpair], feats, teacher=teacher[0])
    tr = get_translator(opt, device="cpu")
    assert isinstance(tr, TranslatorNARFormer)
    got_h, got_s = tr.translate_batch(port, feats, teacher=teacher[1])
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-4)
    assert np.shape(got_h) == (3, 1, opt["max_len"])
    # without the teacher too
    want_h, want_s = jax_get_translator(opt).translate_batch([jpair], feats)
    got_h, got_s = tr.translate_batch(port, feats)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-4)


def test_fused_statistics_equal_dense_logits(students, teacher,
                                             monkeypatch):
    """One call of the argmax/lse function per refinement pass and per
    teacher rescoring (mask-predict with the template, 5 iterations: 6 + 1
    a batch), and the decode of the dense logits."""
    opt, _, port = students["NACF"]
    feats = _feats(opt, 3, seed=5)
    calls = []
    plain = fht._argmax_lse_plain
    monkeypatch.setattr(fht, "_argmax_lse_plain",
                        lambda *a: calls.append(a[3] is not None)
                        or plain(*a))
    tr = get_translator(opt, device="cpu")
    fused = tr.translate_batch(port, feats, teacher=teacher[1])
    assert calls == [False] * 6 + [True]
    assert (tr.decoder_passes, tr.teacher_passes) == (6, 1)
    dense_tr = get_translator(dict(opt, fused_head_topk=False), device="cpu")
    dense = dense_tr.translate_batch(port, feats, teacher=teacher[1])
    assert len(calls) == 7 and dense_tr.decoder_passes == 6
    assert fused[0] == dense[0]
    np.testing.assert_allclose(fused[1], dense[1], rtol=0, atol=1e-6)


def test_teacher_vocabulary_mapping(students, teacher):
    """A teacher whose word ids are permuted (specials kept) scores through
    the mapping as the original teacher scores through the identity, and
    the port's mapped rescoring matches the JAX package's."""
    import copy

    opt, jpair, port = students["NACF"]
    opt = dict(opt, masking_decision=True)
    V = opt["vocab_size"]
    rs = np.random.RandomState(11)
    mapping = np.arange(V)
    mapping[6:] = 6 + rs.permutation(V - 6)
    permuted = copy.deepcopy(teacher[1])
    with torch.no_grad():
        emb = permuted.decoder.embedding.word_embeddings
        head = permuted.cls_head.tgt_word_prj.weight
        emb[torch.as_tensor(mapping)] = emb.clone()
        head[torch.as_tensor(mapping)] = head.clone()
    feats = _feats(opt, 3, seed=6)
    tr = get_translator(opt, device="cpu")
    want = tr.translate_batch(port, feats, teacher=teacher[1],
                              vocab_mapping=np.arange(V))
    got = tr.translate_batch(port, feats, teacher=permuted,
                             vocab_mapping=mapping)
    assert got[0] == want[0]
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-6)
    assert got != tr.translate_batch(port, feats, teacher=permuted)
    # the JAX package with the permuted mapping on the original teacher
    jax_h, jax_s = jax_get_translator(opt).translate_batch(
        [jpair], feats, teacher=teacher[0], vocab_mapping=mapping)
    port_h, port_s = tr.translate_batch(port, feats, teacher=teacher[1],
                                        vocab_mapping=mapping)
    assert port_h == jax_h
    np.testing.assert_allclose(port_s, jax_s, rtol=0, atol=2e-4)


def test_grouped_decoding_equals_batch_by_batch(students, teacher):
    opt, _, port = students["NACF"]
    tr = get_translator(opt, device="cpu")
    batches = [_feats(opt, n, seed=20 + i)
               for i, n in enumerate((3, 3, 2, 3, 1))]
    want = [tr.translate_batch(port, b, teacher=teacher[1])
            for b in batches]
    got = list(tr.translate_batches_grouped(
        port, ((i, b) for i, b in enumerate(batches)), 4,
        teacher=teacher[1]))
    assert [t for t, _ in got] == list(range(len(batches)))
    assert [out for _, out in got] == want
    assert tr.translate_batches_fused(port, batches[:2],
                                      teacher=teacher[1]) == want[:2]


@pytest.mark.parametrize("head_f32", [False, True])
def test_bf16_decode_matches_jax(students, teacher, head_f32):
    """The student and the teacher served as bf16 copies (the caller's
    models stay f32), against the JAX package's bf16 NAR decode: the same
    hypotheses, log-probs within ``BF16_LOGP_TOL``."""
    opt, jpair, port = students["NACF"]
    opt = dict(opt, compute_dtype_decode="bfloat16",
               decode_head_f32=head_f32, masking_decision=True)
    feats = _feats(opt, 3, seed=8)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [jpair], feats, teacher=teacher[0])
    tr = get_translator(opt, device="cpu")
    got_h, got_s = tr.translate_batch(port, feats, teacher=teacher[1])
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=BF16_LOGP_TOL)
    assert all(p.dtype == torch.float32 for p in port.parameters())
    served = tr.serving_model(teacher[1])
    assert served.cls_head.tgt_word_prj.weight.dtype == (
        torch.float32 if head_f32 else torch.bfloat16)
    assert served.decoder.embedding.word_embeddings.dtype == torch.bfloat16


def test_length_beam_breaks_ties_as_lax_top_k():
    """Equal length probabilities rank the shorter length first, as
    ``lax.top_k`` does (``torch.topk`` promises no order among ties); the
    bias and the clip to [4, max_len] follow; without a length predictor
    the beam is ``na_length_range``."""
    import jax

    opt = dict(tiny_opt(STUDENTS["NAB"]), length_bias=1, length_beam_size=4)
    tr = get_translator(opt, device="cpu")
    preds = np.log(np.array([[0.1, 0.2, 0.2, 0.05, 0.2, 0.05, 0.1, 0.1],
                             [0.25, 0.25, 0.25, 0.25, 0, 0, 0, 0]],
                            np.float32) + 1e-9)
    lbs, beam = tr._length_beam({"preds_length": torch.as_tensor(preds)}, 2)
    want = np.clip(np.asarray(jax.lax.top_k(preds, 4)[1]) + 1, 4,
                   opt["max_len"])
    assert lbs == 4
    np.testing.assert_array_equal(beam.numpy(), want)
    assert beam.tolist() == [[4, 4, 5, 4], [4, 4, 4, 4]]
    lbs, beam = tr._length_beam({}, 2)
    lo, hi = opt["na_length_range"]
    assert lbs == hi - lo and beam.tolist() == [list(range(lo, hi))] * 2


def test_nar_resample_indexes_in_f32_as_jax():
    """Resampling 26 encoder frames to a row of 22 tokens: position 11
    takes frame int(11 x f32(26 / 22)) = 12, where an f64 scale gives 13."""
    from care_tpu.models.decoders import nar_resample as jax_resample
    from care_tpu_torch import constants
    from care_tpu_torch.models.decoders import nar_resample

    T, D = 26, 3
    source = np.arange(2 * T * D, dtype=np.float32).reshape(2, T, D)
    tokens = np.full((2, 30), constants.PAD, np.int64)
    tokens[0, :22] = 7
    tokens[1, :5] = 7
    got = nar_resample(torch.as_tensor(source), torch.as_tensor(tokens))
    want = jax_resample(jnp.asarray(source), jnp.asarray(tokens, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0, 11, 0] == source[0, 12, 0]
    assert int(11 * (26 / 22)) == 13


@pytest.mark.parametrize("enhance_input", [0, 1])
def test_enhance_input_matches_jax(enhance_input):
    """The NAR decoder's input enhancement other than the default mean
    (2, every paper command): none, and the encoder states resampled to
    each row's length; the full forward's logits within 2e-4 and the
    decode token for token."""
    from care_tpu_torch import constants
    from care_tpu_torch.training.trainer import device_batch

    opt = dict(tiny_opt(STUDENTS["NAB"]), enhance_input=enhance_input)
    jmodel, variables, port = flagship_pair(opt, seed=9)
    batch = synthetic_batch(opt, 3, seed=10)
    batch["input_ids"][0, 3:] = constants.PAD
    want = jmodel.apply(variables, batch, deterministic=True)["logits"]
    with torch.no_grad():
        got = port(device_batch(batch, "cpu"))["logits"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=2e-4)
    feats = {"feats": batch["feats"]}
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], feats)
    got_h, got_s = get_translator(opt, device="cpu").translate_batch(
        port, feats)
    assert got_h == want_h
    np.testing.assert_allclose(got_s, want_s, rtol=0, atol=2e-4)
