"""The working-dtype decision of the redesigned vocab kernels, on the CPU.

``care_tpu_torch/csrc/tile_logits_tc.cuh`` takes f32 products through the
tensor cores as three TF32 products (3xTF32): each operand x splits into
hi = tf32_rn(x) and lo = tf32_rn(x - hi), and a product accumulates
lo*hi + hi*lo + hi*hi in f32, one mma step of depth 8 at a time. This file
keeps a plain emulation of that arithmetic (numpy, float32) and holds it
against an f64 product at a narrow size, with the tolerances
``chip_smoke.py`` holds the kernels to:

* K1 (fused head + top-k): m and log s within 1e-5 relative + 1e-6, the
  top-5 values within 1e-4;
* K3b (fused cross-entropy dW): rtol 1e-4, atol 2e-7;
* K2 (argmax / lse statistics of the training forward) at the full vocab
  V = 11000: lse, max and label logit within 1e-5, the sum within 1e-4
  relative + 1e-3, the argmax on rows whose top two are 1e-4 apart;
* K3a (fused cross-entropy dh) at V = 11000: rtol 1e-4, atol 2e-7, its
  11000-long reduction taken as the kernel takes it: each mma step of 8
  vocab columns from zero, then added to the sums in f32. Here one TF32
  product spends most of the tolerance without missing it (see the test).

K2, K3a and K3b form the logits in 64-deep chunks (``chunk_logits`` in
``tile_logits_tc.cuh``): within a chunk, mma step s accumulates into set
s % 4, and the chunk adds (p0 + p1) + (p2 + p3) to the logits;
``chunked_logits`` below emulates that order.

3xTF32 meets them; one TF32 product (hi*hi alone) does not, which is why
the kernels take three. Equal vocab columns give bit-equal emulated logits:
every column is the same sequence of operations.
"""

import numpy as np
import pytest

ROWS, H, V, K = 64, 512, 2048, 5


def tf32_rn(x):
    """x rounded to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero (cvt.rna.tf32.f32), on the int32 view."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split(x):
    hi = tf32_rn(x)
    return hi, tf32_rn(x.astype(np.float32) - hi)


def emulated_product(a, b, terms):
    """a [m, k] @ b [n, k]^T in float32 as the kernels run it: per mma step
    of depth 8, each of ``terms`` (pairs of (a part, b part)) adds the sum of
    its eight exact products to the accumulator, in a fixed order."""
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    parts = {"hi": (a_hi, b_hi), "lo": (a_lo, b_lo)}
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        for pa, pb in terms:
            x = parts[pa][0][:, None, k0:k0 + 8]
            y = parts[pb][1][None, :, k0:k0 + 8]
            prod = x * y                  # TF32 x TF32 is exact in f32
            step = prod[..., 0]
            for e in range(1, prod.shape[-1]):
                step = step + prod[..., e]
            acc = acc + step
    return acc


THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))
ONE = (("hi", "hi"),)
ARITHMETIC = {"3xtf32": THREE, "1xtf32": ONE}


def head_inputs(seed):
    """The distribution of ``chip_smoke.py:_head_inputs`` (f32)."""
    rs = np.random.RandomState(seed)
    h = rs.standard_normal((ROWS, H)).astype(np.float32)
    W = ((rs.random_sample((V, H)) * 2 - 1)
         * (6 / (H + V)) ** 0.5).astype(np.float32)
    return h, W


def stats(x):
    x = x.astype(np.float64)
    m = x.max(axis=1)
    log_s = np.log(np.exp(x - m[:, None]).sum(axis=1))
    cv = -np.sort(-x, axis=1)[:, :K]
    return m, log_s, cv


def within(got, want, rtol, atol):
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


@pytest.mark.parametrize("arith", ["3xtf32", "1xtf32"])
def test_head_statistics_tolerance(arith):
    h, W = head_inputs(0)
    want = stats(h.astype(np.float64) @ W.astype(np.float64).T)
    got = stats(emulated_product(h, W, ARITHMETIC[arith]))
    meets = (within(got[0], want[0], 1e-5, 1e-6)
             and within(got[1], want[1], 1e-5, 1e-6)
             and within(got[2], want[2], 0.0, 1e-4))
    assert meets == (arith == "3xtf32"), [
        float(np.abs(g - w).max()) for g, w in zip(got, want)]


def xent_dw(h, W, product):
    """dW [V, H] of the fused cross-entropy with the cotangents of
    ``chip_smoke.py:_xent_inputs`` (f32, no bias): the logits and dW through
    ``product``, lse from the f64 forward as the kernel takes it."""
    rs = np.random.RandomState(1)
    labels = rs.randint(6, V, ROWS)
    pad = rs.random_sample(ROWS) < 0.2
    labels[pad] = 0
    keep = (~pad).astype(np.float64) / 64
    gl = keep * (0.9 + 0.2 * rs.random_sample(ROWS))
    gb = -keep * (0.8 + 0.2 * rs.random_sample(ROWS))
    gs = -keep * 0.1 / V * (1 + rs.random_sample(ROWS))
    x64 = h.astype(np.float64) @ W.astype(np.float64).T
    lse = np.log(np.exp(x64).sum(axis=1))
    x = x64 if product is None else product(h, W).astype(np.float64)
    onehot = np.arange(V)[None, :] == labels[:, None]
    d = gl[:, None] * np.exp(x - lse[:, None]) + np.where(
        onehot, gb[:, None], 0.0) + gs[:, None]
    if product is None:
        return d.T @ h.astype(np.float64)
    return product(np.ascontiguousarray(d.T, np.float32),
                   np.ascontiguousarray(h.T))


@pytest.mark.parametrize("arith", ["3xtf32", "1xtf32"])
def test_dw_tolerance(arith):
    h, W = head_inputs(2)
    want = xent_dw(h, W, None)
    got = xent_dw(h, W,
                  lambda a, b: emulated_product(a, b, ARITHMETIC[arith]))
    meets = within(got, want, 1e-4, 2e-7)
    assert meets == (arith == "3xtf32"), float(np.abs(got - want).max())


@pytest.mark.parametrize("arith", ["3xtf32", "1xtf32"])
def test_equal_columns_give_bit_equal_logits(arith):
    h, W = head_inputs(3)
    W = W[np.arange(V) % 37]          # every column repeats 37 later
    x = emulated_product(h, W, ARITHMETIC[arith])
    np.testing.assert_array_equal(x, x[:, np.arange(V) % 37])


def test_split_is_exact_to_tf32():
    rs = np.random.RandomState(4)
    x = (rs.standard_normal(10000)
         * np.exp2(rs.randint(-20, 20, 10000))).astype(np.float32)
    hi, lo = split(x)
    for part in (hi, lo):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))
    # hi keeps 11 significant bits, hi + lo about 22
    assert np.all(np.abs(x - hi) <= np.abs(x) * 2.0 ** -11)
    assert np.all(np.abs(x.astype(np.float64) - hi - lo)
                  <= np.abs(x) * 2.0 ** -21)


# ---------------------------------------------------------------------------
# K2 and K3a at the full vocab, in the kernels' chunk order
# ---------------------------------------------------------------------------

XROWS, XH, XV = 16, 512, 11000


def _sum8(prod):
    """The eight exact products of one mma step, added in order in f32."""
    t = prod[..., 0]
    for e in range(1, prod.shape[-1]):
        t = t + prod[..., e]
    return t


def chunked_logits(a, b, terms):
    """a [m, k] @ b [n, k]^T in f32 as ``chunk_logits`` forms it: per 64-deep
    chunk, four accumulator sets from zero, step s (depth 8) adding each
    term's eight products into set s % 4, then x += (p0 + p1) + (p2 + p3)."""
    halves = {"a": split(a), "b": split(b)}
    pick = {"hi": 0, "lo": 1}
    x = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for c0 in range(0, a.shape[1], 64):
        sets = [np.zeros_like(x) for _ in range(4)]
        for s in range(min(64, a.shape[1] - c0) // 8):
            k0 = c0 + 8 * s
            for pa, pb in terms:
                xa = halves["a"][pick[pa]][:, None, k0:k0 + 8]
                yb = halves["b"][pick[pb]][None, :, k0:k0 + 8]
                sets[s % 4] = sets[s % 4] + _sum8(xa * yb)
        x = x + ((sets[0] + sets[1]) + (sets[2] + sets[3]))
    return x


def stepwise_product(a, b, terms):
    """a [m, k] @ b [n, k]^T in f32 as K3a's dh product takes it: each mma
    step (depth 8) from a zero accumulator, its terms in order, then added
    to the sums with an f32 add, step after step."""
    halves = {"a": split(a), "b": split(b)}
    pick = {"hi": 0, "lo": 1}
    m, k = a.shape
    out = np.zeros((m, b.shape[0]), np.float32)
    for n0 in range(0, b.shape[0], 64):       # in column blocks, for memory
        n = min(64, b.shape[0] - n0)
        steps = np.zeros((m, n, k // 8), np.float32)
        for pa, pb in terms:
            xa = halves["a"][pick[pa]].reshape(m, 1, k // 8, 8)
            yb = halves["b"][pick[pb]][n0:n0 + n].reshape(1, n, k // 8, 8)
            steps = steps + _sum8(xa * yb)
        out[:, n0:n0 + n] = np.add.accumulate(steps, axis=2,
                                              dtype=np.float32)[..., -1]
    return out


def xent_case(H):
    """Rows of h, W, labels (one row on PAD) and the cotangents of
    ``chip_smoke.py:_xent_inputs`` (f32, no bias) at the full vocab."""
    rs = np.random.RandomState(5)
    h = rs.standard_normal((XROWS, H)).astype(np.float32)
    W = ((rs.random_sample((XV, H)) * 2 - 1)
         * (6 / (H + XV)) ** 0.5).astype(np.float32)
    labels = rs.randint(6, XV, XROWS)
    labels[3] = 0
    keep = (labels != 0).astype(np.float64) / 64
    gl = keep * (0.9 + 0.2 * rs.random_sample(XROWS))
    gb = -keep * (0.8 + 0.2 * rs.random_sample(XROWS))
    gs = -keep * 0.1 / XV * (1 + rs.random_sample(XROWS))
    return h, W, labels, (gl, gb, gs)


def xent_stats(x, labels):
    x = x.astype(np.float64)
    m = x.max(axis=1)
    lse = m + np.log(np.exp(x - m[:, None]).sum(axis=1))
    return (lse, m, x[np.arange(len(labels)), labels], x.sum(axis=1),
            x.argmax(axis=1))


@pytest.mark.parametrize("arith", ["3xtf32", "1xtf32"])
def test_k2_statistics_tolerance(arith):
    h, W, labels, _ = xent_case(XH)
    x64 = h.astype(np.float64) @ W.astype(np.float64).T
    want = xent_stats(x64, labels)
    got = xent_stats(chunked_logits(h, W, ARITHMETIC[arith]), labels)
    top2 = -np.sort(-x64, axis=1)[:, :2]
    sep = top2[:, 0] - top2[:, 1] > 1e-4
    assert sep.sum() >= XROWS // 2
    meets = (all(within(got[i], want[i], 1e-5, 1e-5) for i in range(3))
             and within(got[3], want[3], 1e-4, 1e-3)
             and np.array_equal(got[4][sep], want[4][sep]))
    assert meets == (arith == "3xtf32"), [
        float(np.abs(g - w).max()) for g, w in zip(got[:4], want[:4])]


@pytest.mark.parametrize("arith", ["3xtf32", "1xtf32"])
def test_k3a_dh_tolerance(arith):
    """dh against f64 at the full vocab: 3xTF32 meets rtol 1e-4 + atol 2e-7
    with a hundredfold margin. One TF32 product does not miss it at this
    scale: dh is about 3e-4, so the tolerance is about 2**-10 relative,
    where one TF32 product keeps 2**-11 per operand; it spends more than
    half of the tolerance, and that share is what its case asserts. K3a
    takes three all the same: its logits must be K2's, bit for bit, and K2's
    lse misses its tolerance with one (``test_k2_statistics_tolerance``)."""
    h, W, labels, (gl, gb, gs) = xent_case(XH)
    x64 = h.astype(np.float64) @ W.astype(np.float64).T
    lse = np.log(np.exp(x64).sum(axis=1))
    onehot = np.arange(XV)[None, :] == labels[:, None]

    def dlogits(x):
        return (gl[:, None] * np.exp(x - lse[:, None])
                + np.where(onehot, gb[:, None], 0.0) + gs[:, None])

    want = dlogits(x64) @ W.astype(np.float64)
    terms = ARITHMETIC[arith]
    d = dlogits(chunked_logits(h, W, terms).astype(np.float64))
    got = stepwise_product(d.astype(np.float32), np.ascontiguousarray(W.T),
                           terms)
    assert np.all(got[3] == 0.0)                    # the PAD row
    spent = float((np.abs(got - want) / (2e-7 + 1e-4 * np.abs(want))).max())
    if arith == "3xtf32":
        assert spent <= 0.01, spent
    else:
        assert spent > 0.5, spent
