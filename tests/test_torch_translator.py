"""The port's AR decoding (``care_tpu_torch/decoding``) against the JAX
package's: the beam search driven by one seeded log-prob table through both
stacks, and ``translate_batch`` of the CARE flagship (test size) on the
same weights. Hypotheses must be token-identical, scores within 1e-4.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from care_tpu import constants
from care_tpu.decoding import beam_search as jax_beam_search
from care_tpu.decoding import get_translator as jax_get_translator
from care_tpu_torch.decoding import beam_search as port_beam_search
from care_tpu_torch.decoding import get_translator as port_get_translator
from care_tpu_torch.decoding.step_graphs import StepGraphs
from care_tpu_torch.models.weights import params_from_jax

from test_torch_support import (flagship_pair, flagship_small_opt,
                                synthetic_feats)


def _table(N, max_len, V, seed):
    """Per-instance log-probs [N, max_len, V(prev token), V(next)]:
    instance 0 likes EOS (its buffer fills early), instance 1 almost never
    emits it (forced finish at max_len), the rest sit in between."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(N, max_len, V, V) * 2.0
    logits[0, 2:, :, constants.EOS] += 3.0
    logits[1, :, :, constants.EOS] -= 30.0
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    return logits.astype(np.float32)


def _cases(*cases):
    """``cases`` under their plain ids, then each again on the static step
    body (``decoding/step_graphs.py``, run eagerly on the CPU) as
    ``<id>-static``."""
    ids = ["-".join(map(str, c)) for c in cases]
    return ([pytest.param(*c, False, id=i) for c, i in zip(cases, ids)]
            + [pytest.param(*c, True, id=i + "-static")
               for c, i in zip(cases, ids)])


@pytest.mark.parametrize("beam_size,topk,alpha,static",
                         _cases((3, 1, 1.0), (3, 4, 0.7), (4, 2, 1.3)))
def test_beam_search_matches_jax(beam_size, topk, alpha, static):
    N, V, max_len = 4, 11, 9
    table = _table(N, max_len, V, seed=beam_size + topk)
    rows = np.repeat(np.arange(N), beam_size)
    kw = dict(batch_size=N, vocab_size=V, beam_size=beam_size,
              max_len=max_len, beam_alpha=alpha, topk=topk)

    jt = jnp.asarray(table)
    want = jax_beam_search(
        lambda tok, pos, inst: (jt[inst, pos, tok], inst),
        jnp.asarray(rows), **kw)
    tt = torch.as_tensor(table)
    got = port_beam_search(
        lambda tok, pos, inst: (tt[inst, pos, tok], inst),
        torch.as_tensor(rows), gather_carry=lambda inst, idx: inst[idx],
        device="cpu", graphs=StepGraphs("cpu") if static else None, **kw)
    hyp_tokens, hyp_scores, hyp_lengths, hyp_valid = (
        np.asarray(x) for x in want)
    np.testing.assert_array_equal(got[0].numpy(), hyp_tokens)
    np.testing.assert_allclose(got[1].numpy(), hyp_scores, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(got[2].numpy(), hyp_lengths)
    np.testing.assert_array_equal(got[3].numpy(), hyp_valid)
    # the table's design reached both ends of the bookkeeping
    assert (hyp_lengths[1][hyp_valid[1]] == max_len - 1).all()  # forced
    assert (hyp_lengths[0][hyp_valid[0]] < max_len - 1).all()   # early EOS


@pytest.fixture(scope="module")
def flagship():
    """Random weights whose beams end at every length: the head's EOS
    column is 0.8 x the column of token 37, the token these weights repeat
    most, so EOS is often a near-best candidate and hypotheses finish early,
    late, or are forced to finish at max_len."""
    opt = flagship_small_opt(vocab_size=40)
    jmodel, variables, port = flagship_pair(opt, seed=3)
    kernel = variables["params"]["cls_head"]["tgt_word_prj"]["kernel"]
    kernel[:, constants.EOS] = 0.8 * kernel[:, 37]
    params_from_jax(port, variables["params"])
    return opt, jmodel, variables, port


@pytest.mark.parametrize("batch_size,topk,static", _cases((4, 1), (3, 2)))
def test_translate_batch_matches_jax(flagship, batch_size, topk, static):
    """Token-identical hypotheses and scores within 1e-4 on the same
    weights; batch 3 is the ragged tail of a batch-4 stream."""
    opt, jmodel, variables, port = flagship
    opt = dict(opt, topk=topk)
    feats = synthetic_feats(opt, batch_size, seed=batch_size)
    want_h, want_s = jax_get_translator(opt).translate_batch(
        [(jmodel, variables)], {"feats": feats})
    tr = port_get_translator(opt, device="cpu")
    if static:
        tr._graphs_engage = lambda model: True
    got_h, got_s = tr.translate_batch(port, {"feats": feats})
    assert len(tr._static) == static
    assert got_h == want_h
    for g, w in zip(got_s, want_s):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
    lengths = {len(h) for hyps in got_h for h in hyps}
    assert len(lengths) > 1, lengths        # EOS-finished hypotheses too


def test_fused_and_unfused_heads_and_pipelined_batches_agree(flagship):
    """The fused head + top-k path against log_softmax over the full
    logits, and ``translate_batches`` against ``translate_batch``."""
    opt, _, _, port = flagship
    batches = [{"feats": synthetic_feats(opt, n, seed=20 + n)}
               for n in (4, 4, 3)]
    fused = port_get_translator(opt, device="cpu")
    plain = port_get_translator(dict(opt, fused_head_topk=False),
                                device="cpu")
    streamed = list(fused.translate_batches(port, batches, depth=2))
    assert [b for b, _ in streamed] == batches  # same objects, in order
    for batch, (hyps, scores) in streamed:
        want_h, want_s = plain.translate_batch(port, batch)
        assert hyps == want_h
        np.testing.assert_allclose(scores, want_s, rtol=0, atol=1e-5)
    assert fused.beam_steps == plain.beam_steps
