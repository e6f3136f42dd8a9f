"""The port's NAR decoding algorithms (``care_tpu_torch/decoding/nar.py``)
against the JAX package's (``care_tpu/decoding/nar.py``).

Both sides get the same deterministic "decoder": logits that depend on the
whole canvas (a position table, the token's row of a word table, and its
left neighbour's), built from a numpy seed and computed in f32 by each
framework, and a teacher score from the same tables. MaskPredict,
Left2Right and EasyFirst, with and without the coarse-grained template
(``use_ct``), with and without a teacher, through the logits and through a
statistics forward: tokens identical, log-probs within 1e-6. A fixture of
exact probability ties and rows of one to three tokens holds
``select_worst`` and EasyFirst's rank to the JAX package's stable sorts,
and the mask counts are checked to multiply in f32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.decoding import nar as jax_nar
from care_tpu_torch import constants
from care_tpu_torch.decoding import nar

V, L = 23, 10


def _tables(seed):
    rs = np.random.RandomState(seed)
    return (rs.randn(L, V).astype(np.float32),
            (2.0 * rs.randn(V, V)).astype(np.float32),
            rs.randn(V, V).astype(np.float32),
            rs.randn(V).astype(np.float32))


def _canvas(lengths):
    pos = np.arange(L)[None, :]
    return np.where(pos < np.asarray(lengths)[:, None], constants.MASK,
                    constants.PAD).astype(np.int64)


def _jax_fns(tables):
    pos, word, left, teach = (jnp.asarray(t) for t in tables)

    def logits(tokens):
        prev = jnp.concatenate([jnp.full_like(tokens[:, :1], constants.BOS),
                                tokens[:, :-1]], axis=1)
        return pos[None] + word[tokens] + left[prev]

    def stats(tokens):
        ids, probs, _ = jax_nar.generate_step_with_prob(logits(tokens))
        return ids, probs

    def teacher(tokens, is_last):
        return jnp.where(tokens == constants.PAD, 1.0,
                         1.0 / (1.0 + jnp.exp(-teach[tokens])))
    return logits, stats, teacher


def _port_fns(tables):
    pos, word, left, teach = (torch.as_tensor(t) for t in tables)

    def logits(tokens):
        prev = torch.cat([torch.full_like(tokens[:, :1], constants.BOS),
                          tokens[:, :-1]], dim=1)
        return pos[None] + word[tokens] + left[prev]

    def stats(tokens):
        ids, probs, _ = nar.generate_step_with_prob(logits(tokens))
        return ids, probs

    def teacher(tokens, is_last):
        return torch.where(tokens == constants.PAD, 1.0,
                           1.0 / (1.0 + torch.exp(-teach[tokens])))
    return logits, stats, teacher


def _both(paradigm, canvas, tables, with_teacher, with_stats, **kwargs):
    jl, js, jt = _jax_fns(tables)
    pl, ps, pt = _port_fns(tables)
    want = getattr(jax_nar, paradigm)(
        jnp.asarray(canvas, jnp.int32), jl,
        teacher_score=jt if with_teacher else None,
        forward_stats=js if with_stats else None, **kwargs)
    got = getattr(nar, paradigm)(
        torch.as_tensor(canvas), pl,
        teacher_score=pt if with_teacher else None,
        forward_stats=ps if with_stats else None, **kwargs)
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("with_teacher", [False, True])
@pytest.mark.parametrize("use_ct", [False, True])
@pytest.mark.parametrize("paradigm,kwargs", [
    ("mask_predict", {"iterations": 5}),
    ("left2right", {"q": 2, "q_iterations": 2}),
    ("easy_first", {"q": 1, "q_iterations": 1})])
def test_algorithm_matches_jax(paradigm, kwargs, use_ct, with_teacher):
    # rows of 10 tokens (MaskPredict's f32 mask count differs from f64's
    # there), shorter rows and one of a single token
    canvas = _canvas([10, 7, 4, 1, 10, 5])
    (want_t, want_p), (got_t, got_p) = _both(
        paradigm, canvas, _tables(1), with_teacher, False, use_ct=use_ct,
        **kwargs)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
    assert (got_t[canvas == constants.PAD] == constants.PAD).all()
    # the decode really refined: words beyond the specials came out
    assert (got_t[canvas != constants.PAD] > constants.VIS).mean() > 0.5


@pytest.mark.parametrize("paradigm", ["mask_predict", "left2right",
                                      "easy_first"])
def test_statistics_forward_equals_logits_forward(paradigm):
    """``forward_stats`` (the fused statistics path) gives what the logits
    forward gives, in both packages."""
    canvas = _canvas([10, 8, 3])
    (jt, jp), (pt, pp) = _both(paradigm, canvas, _tables(2), True, True,
                               use_ct=True)
    (_, _), (lt, lp) = _both(paradigm, canvas, _tables(2), True, False,
                             use_ct=True)
    np.testing.assert_array_equal(pt, jt)
    np.testing.assert_array_equal(pt, lt)
    np.testing.assert_allclose(pp, jp, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(pp, lp)


def _tie_probs():
    """Probabilities with exact ties inside rows (several positions at the
    same value, the PAD positions at 1.0) and short rows."""
    p = np.array([[0.5, 0.25, 0.5, 0.25, 1.0, 1.0],
                  [1.0, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.125, 1.0, 1.0, 1.0, 1.0, 1.0],
                  [0.75, 0.75, 0.75, 0.5, 0.5, 1.0]], np.float32)
    return p


@pytest.mark.parametrize("num_mask", [[0, 0, 0, 0], [1, 2, 1, 3],
                                      [3, 6, 2, 4], [6, 6, 6, 6]])
def test_select_worst_breaks_ties_as_jax(num_mask):
    p = _tie_probs()
    want = np.asarray(jax_nar.select_worst(jnp.asarray(p),
                                           jnp.asarray(num_mask)))
    got = nar.select_worst(torch.as_tensor(p),
                           torch.as_tensor(num_mask)).numpy()
    np.testing.assert_array_equal(got, want)
    # at least one position, ties to the left
    assert (got.sum(1) == np.maximum(num_mask, 1)).all()


def test_easy_first_ties_and_short_rows_match_jax():
    """Every logit row the same: each pass's candidate probabilities tie
    exactly, so EasyFirst's rank over ``-cand`` decides by position alone
    (rows of 1, 2 and 3 tokens beside full ones)."""
    pos = np.zeros((L, V), np.float32)
    word = np.zeros((V, V), np.float32)
    word[:, 9] = 3.0
    word[:, 11] = 3.0       # two words tie for the argmax
    tables = (pos, word, np.zeros((V, V), np.float32),
              np.zeros(V, np.float32))
    canvas = _canvas([1, 2, 3, 10])
    for q in (1, 2):
        (want_t, want_p), (got_t, got_p) = _both(
            "easy_first", canvas, tables, False, False, q=q, q_iterations=1)
        np.testing.assert_array_equal(got_t, want_t)
        np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
        # the lowest id takes the tie
        assert set(got_t[canvas != constants.PAD].tolist()) == {9}


def test_mask_counts_multiply_in_f32():
    """int(10 * (1 - 4/5)) is 1 in f64 and 2 in f32, the JAX package's
    weak-typed product: the port counts 2, as the JAX package does."""
    lens = torch.tensor([10, 5, 30])
    got = nar._f32_count(lens, 1.0 - 4 / 5).tolist()
    want = np.asarray((jnp.asarray([10, 5, 30]).astype(jnp.float32)
                       * (1.0 - 4 / 5)).astype(jnp.int32)).tolist()
    assert got == want == [2, 1, 6]
    assert [int(n * (1.0 - 4 / 5)) for n in (10, 5, 30)] == [1, 0, 5]


def test_left2right_ranks_come_from_the_initial_canvas():
    """With the template (``use_ct``) most positions are filled before the
    left-to-right passes and the boosted MASK logit leaves some MASK; the
    passes walk those positions in order, q at a time, ranked once before
    the first pass (not again after each), as the JAX package does."""
    rs = np.random.RandomState(5)
    tables = list(_tables(3))
    tables[1][:, constants.MASK] += 4.0 * rs.rand(V).astype(np.float32)
    canvas = _canvas([10, 9, 6])
    (want_t, want_p), (got_t, got_p) = _both(
        "left2right", canvas, tuple(tables), False, False, q=3,
        q_iterations=2, use_ct=True)
    np.testing.assert_array_equal(got_t, want_t)
    np.testing.assert_allclose(got_p, want_p, rtol=0, atol=1e-6)
