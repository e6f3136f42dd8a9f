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
* K3b (fused cross-entropy dW): rtol 1e-4, atol 2e-7.

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
