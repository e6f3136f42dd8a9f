"""The working-dtype decision of the flash kernels, on the CPU.

``care_tpu_torch/csrc/flash_attention_fwd.cu`` (the forward's large-query
variant: scores, then p v; at the end of this file),
``flash_attention_bwd_dq.cu`` (dq) and
``flash_attention_bwd_dkv.cu`` (dk, dv, dbias) take their f32 products
through the tensor cores as three TF32 products (3xTF32, as the vocab
kernels: ``tests/test_torch_tf32_split.py``). This file emulates, with
numpy in float32, their arithmetic in their accumulation order and holds
it against an f64 backward at the tolerance ``chip_smoke.py`` holds the
kernels to (rtol 1e-4 + atol 1e-4):

* the scores s = q k^T (dq kernel) and s^T = k q^T (dk/dv kernel) from
  zero over the head width, one mma step of depth 8 at a time, its three
  terms lo*hi + hi*lo + hi*hi in that order;
* p = exp(s * scale + bias - lse), g = p * (do v^T - delta) in f32;
* dq over key tiles of 32, dk and dv over query tiles of 32 (the f32 tiles
  at head width 64): each tile's product from zero, then added to the
  running sum with an f32 add;
* dbias per key: each of a quad's four lanes takes its two query rows
  (2qd, 2qd + 1) of every block of 8, sums a tile's pairs by a pairwise
  tree and adds that to its sum tile after tile; then the quad adds
  (l0 + l1) + (l2 + l3).

3xTF32 meets the tolerance with a wide margin (under 1% of it); one TF32
product (hi*hi alone) misses it on all four gradients
(``test_one_tf32_product_misses``).
"""

import numpy as np
import pytest

from test_torch_tf32_split import ARITHMETIC, emulated_product

B, H, LQ, LK, DH = 1, 2, 130, 200, 64
TILE = 32
TOL = dict(rtol=1e-4, atol=1e-4)


def case():
    """q, k, v, do [B, H, L, Dh] f32 and a bias [B, H, Lk] with a -1e9
    tail, from a seed."""
    rs = np.random.RandomState(0)
    q, k, v, do = (rs.standard_normal((B, H, n, DH)).astype(np.float32)
                   for n in (LQ, LK, LK, LQ))
    bias = (rs.standard_normal((B, H, LK)) * 0.5).astype(np.float32)
    bias[..., -LK // 4:] = -1e9
    return q, k, v, do, bias


def reference(q, k, v, do, bias):
    """The backward in f64, and the forward's lse and delta (f32, as the
    kernels are handed them)."""
    q, k, v, do, bias = (x.astype(np.float64) for x in (q, k, v, do, bias))
    scale = DH ** -0.5
    s = q @ np.swapaxes(k, -1, -2) * scale + bias[:, :, None, :]
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    p = np.exp(s - lse)
    out = p @ v
    delta = (do * out).sum(-1, keepdims=True)
    g = p * (do @ np.swapaxes(v, -1, -2) - delta)
    grads = {"dq": g @ k * scale, "dk": np.swapaxes(g, -1, -2) @ q * scale,
             "dv": np.swapaxes(p, -1, -2) @ do, "dbias": g.sum(-2)}
    return grads, lse[..., 0].astype(np.float32), \
        delta[..., 0].astype(np.float32)


def tiled(a, b, terms):
    """a [m, n] @ b [n, d] over tiles of TILE along n: each tile's product
    from zero (emulated_product), added to the sum in f32."""
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for n0 in range(0, a.shape[1], TILE):
        acc = acc + emulated_product(
            np.ascontiguousarray(a[:, n0:n0 + TILE]),
            np.ascontiguousarray(b[n0:n0 + TILE].T), terms)
    return acc


def quad_row_sums(gt):
    """dbias from g^T [keys, Lq]: lane qd of a quad takes, in every tile,
    the pair of query rows 8j + 2qd, 8j + 2qd + 1 of each block j of 8, sums
    the tile's pairs by a pairwise tree and adds that to its sum; the quad
    adds (l0 + l1) + (l2 + l3)."""
    lq = gt.shape[1]
    padded = np.zeros((gt.shape[0], -(-lq // TILE) * TILE), np.float32)
    padded[:, :lq] = gt
    lanes = []
    for qd in range(4):
        part = np.zeros(gt.shape[0], np.float32)
        for t0 in range(0, padded.shape[1], TILE):
            pairs = [padded[:, t0 + r0 + 2 * qd]
                     + padded[:, t0 + r0 + 2 * qd + 1]
                     for r0 in range(0, TILE, 8)]
            while len(pairs) > 1:
                pairs = [pairs[i] + pairs[i + 1]
                         for i in range(0, len(pairs), 2)]
            part = part + pairs[0]
        lanes.append(part)
    return (lanes[0] + lanes[1]) + (lanes[2] + lanes[3])


def emulated(q, k, v, do, bias, lse, delta, terms):
    """The kernels' dq, dk, dv and dbias in f32 with the given TF32
    terms per mma step."""
    scale = np.float32(DH ** -0.5)
    out = {name: [] for name in ("dq", "dk", "dv", "dbias")}
    for b in range(B):
        for h in range(H):
            qh, kh, vh, doh = q[b, h], k[b, h], v[b, h], do[b, h]
            row_lse, row_delta = lse[b, h][:, None], delta[b, h][:, None]
            # dq kernel: rows the queries
            s = emulated_product(qh, kh, terms) * scale + bias[b, h][None, :]
            dp = emulated_product(doh, vh, terms)
            g = np.exp(s - row_lse) * (dp - row_delta)
            out["dq"].append(tiled(g, kh, terms) * scale)
            # dk/dv kernel: rows the keys
            st = emulated_product(kh, qh, terms) * scale + bias[b, h][:, None]
            dpt = emulated_product(vh, doh, terms)
            pt = np.exp(st - row_lse.T)
            gt = pt * (dpt - row_delta.T)
            out["dv"].append(tiled(pt, doh, terms))
            out["dk"].append(tiled(gt, qh, terms) * scale)
            out["dbias"].append(quad_row_sums(gt))
    return {name: np.stack(x).reshape((B, H) + x[0].shape)
            for name, x in out.items()}


def spent(got, want):
    """The largest share of the tolerance an element uses (1.0: at it)."""
    return float((np.abs(got - want)
                  / (TOL["atol"] + TOL["rtol"] * np.abs(want))).max())


@pytest.fixture(scope="module")
def grads():
    q, k, v, do, bias = case()
    want, lse, delta = reference(q, k, v, do, bias)
    got = {arith: emulated(q, k, v, do, bias, lse, delta, terms)
           for arith, terms in ARITHMETIC.items()}
    return want, got


@pytest.mark.parametrize("name", ["dq", "dk", "dv", "dbias"])
def test_three_tf32_products_meet_the_tolerance(grads, name):
    want, got = grads
    assert np.all(np.isfinite(got["3xtf32"][name]))
    assert spent(got["3xtf32"][name], want[name]) <= 0.05


def test_masked_keys_get_no_gradient(grads):
    """Keys under the -1e9 tail weigh exactly 0: their dk, dv and dbias
    are 0 in the emulation as in f64."""
    _, got = grads
    for name in ("dk", "dv"):
        assert not np.any(got["3xtf32"][name][:, :, -LK // 4:])
    assert not np.any(got["3xtf32"]["dbias"][..., -LK // 4:])


@pytest.mark.parametrize("name", ["dq", "dk", "dv", "dbias"])
def test_one_tf32_product_misses(grads, name):
    """One TF32 product (hi*hi alone) keeps 2**-11 per operand. At this
    shape it misses the tolerance on every gradient, by 4.8x (dq) to 11x
    (dbias), where three products spend under 1% of it: the kernels take
    three."""
    want, got = grads
    assert spent(got["1xtf32"][name], want[name]) > 1.0


# ---------------------------------------------------------------------------
# the forward (flash_attention_fwd.cu), large-query variant
# ---------------------------------------------------------------------------
#
# Scores s = q k^T from zero over the head width per 32-key tile, one mma
# step of depth 8 at a time, its TF32 terms in order; x = s * scale + bias;
# the online softmax per tile (maximum from -1e9, alpha = exp(m - m_new),
# the sum of the unrounded weights); the output accumulators rescaled by
# alpha and each tile's p v added from zero with an f32 add. chip_smoke.py
# holds the kernel at rtol 1e-4 + atol 2e-5 for out and 1e-5 + 2e-5 for lse.

FWD_TOL = {"out": dict(rtol=1e-4, atol=2e-5), "lse": dict(rtol=1e-5, atol=2e-5)}


def forward_reference(q, k, v, bias):
    """out and lse in f64."""
    q, k, v, bias = (x.astype(np.float64) for x in (q, k, v, bias))
    s = q @ np.swapaxes(k, -1, -2) * DH ** -0.5 + bias[:, :, None, :]
    m = s.max(-1, keepdims=True)
    lse = m + np.log(np.exp(s - m).sum(-1, keepdims=True))
    return {"out": np.exp(s - lse) @ v, "lse": lse[..., 0]}


def forward_emulated(q, k, v, bias, terms):
    """The kernel's out and lse in f32 with the given TF32 terms per mma
    step."""
    scale = np.float32(DH ** -0.5)
    out = np.zeros(q.shape, np.float32)
    lse = np.zeros(q.shape[:3], np.float32)
    for b in range(B):
        for h in range(H):
            m = np.full((LQ, 1), -1e9, np.float32)
            l = np.zeros((LQ, 1), np.float32)
            acc = np.zeros((LQ, DH), np.float32)
            for k0 in range(0, LK, TILE):
                kt, vt = k[b, h, k0:k0 + TILE], v[b, h, k0:k0 + TILE]
                x = (emulated_product(q[b, h], kt, terms) * scale
                     + bias[b, h, None, k0:k0 + TILE])
                m_new = np.maximum(m, x.max(-1, keepdims=True))
                alpha = np.exp(m - m_new)
                p = np.exp(x - m_new)
                l = alpha * l + p.sum(-1, keepdims=True, dtype=np.float32)
                acc = acc * alpha + emulated_product(
                    p, np.ascontiguousarray(vt.T), terms)
                m = m_new
            out[b, h] = acc / l
            lse[b, h] = (m + np.log(l))[:, 0]
    return {"out": out, "lse": lse}


def forward_spent(got, want, name):
    tol = FWD_TOL[name]
    return float((np.abs(got - want)
                  / (tol["atol"] + tol["rtol"] * np.abs(want))).max())


@pytest.fixture(scope="module")
def forward():
    q, k, v, _, bias = case()
    want = forward_reference(q, k, v, bias)
    got = {arith: forward_emulated(q, k, v, bias, terms)
           for arith, terms in ARITHMETIC.items()}
    return want, got


@pytest.mark.parametrize("name", ["out", "lse"])
def test_forward_three_tf32_products_meet_the_tolerance(forward, name):
    want, got = forward
    assert np.all(np.isfinite(got["3xtf32"][name]))
    assert forward_spent(got["3xtf32"][name], want[name], name) <= 0.05


def test_forward_one_tf32_product_misses(forward):
    """One TF32 product (hi*hi alone) in both products of the forward: at
    this shape it misses the output's tolerance by 10.8x and the lse's by
    2.5x, where three products spend under 1% of them: the kernel takes
    three."""
    want, got = forward
    for name in ("out", "lse"):
        assert forward_spent(got["1xtf32"][name], want[name], name) > 1.0
