"""Operands and checks of the port's CUDA kernels on the card.

The ``gpu`` tests of ``test_torch_fused_head_topk.py`` (K1),
``test_torch_fused_xent.py`` (K2, K3a, K3b), ``test_torch_flash_attention.py``
(K4a, K4b, K4c) and ``test_torch_beam_bookkeeping.py`` hold each kernel
against its plain version through the checks here, over their own case
lists, the flagship's widths among them (H 512, V 11 000, beam 5,
``max_len`` 30, batch 64 and the ragged batch of 17;
``test_torch_config_and_imports.py`` holds these constants to
``chip_smoke.flagship_opt``). ``chip_smoke.py`` runs each check once at
the main path's shapes and takes its operands from the same makers.

Imports torch, numpy and the port's kernel modules only (no JAX), so that
the ``gpu`` run on the card and ``chip_smoke.py`` may use it. The makers of
the head, cross-entropy and attention operands put them on the card.
"""

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.ops import beam_bookkeeping as bb
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.ops import fused_xent as fx
from care_tpu_torch.ops.attention import dot_product_attention

f32, bf16 = torch.float32, torch.bfloat16
BATCH, RAGGED = 64, 17
# the flagship serving configuration (chip_smoke.py:flagship_opt)
BEAM, TOPK, MAX_LEN, H, V = 5, 1, 30, 512, 11000
# the trainer's rows at the flagship's shape: batch x (max_len - 1)
XENT_ROWS = BATCH * (MAX_LEN - 1)
# the decode step of the long-key configuration (batch 64, 8 heads, beam 5
# folded into the query rows, 1654 keys), the ragged batch of 17 (136
# (batch, head) pairs, about one an SM, whose keys K4a splits over a
# cluster of blocks) and the square shape of the backward kernels,
# [B, H, Lq, Lk, Dh]
DECODE_SHAPE = (BATCH, 8, 5, 1654, 64)
RAGGED_DECODE_SHAPE = (RAGGED, 8, 5, 1654, 64)
SQUARE_SHAPE = (4, 8, 1568, 1568, 64)
# (label, shape, dtype, bias kind, seed) of ``check_flash_case``
FLASH_CASES = [
    ("decode", DECODE_SHAPE, f32, "hybrid", 11),
    ("decode, no bias", DECODE_SHAPE, f32, None, 12),
    ("square", SQUARE_SHAPE, f32, "hybrid", 13),
    ("pad mask", (3, 4, 70, 333, 64), f32, "pad", 16),
    ("query-extent bias", (2, 4, 70, 333, 64), f32, "rpe", 17),
    ("all-masked instance", (2, 4, 5, 333, 64), f32, "masked", 18),
    ("bf16 decode", RAGGED_DECODE_SHAPE, bf16, "hybrid", 20),
]


def head_inputs(rows, H, V, dtype, exact, seed):
    """h [rows, H], W [V, H] on the card. ``exact`` draws small dyadic
    values whose products and sums are exact in f32, so any summation order
    gives bit-identical logits (and exact ties where columns repeat)."""
    g = torch.Generator().manual_seed(seed)
    if exact:
        h = torch.randint(-4, 5, (rows, H), generator=g).float() / 8
        W = torch.randint(-8, 9, (V, H), generator=g).float() / 64
    else:
        h = torch.randn((rows, H), generator=g)
        W = (torch.rand((V, H), generator=g) * 2 - 1) * (6 / (H + V)) ** 0.5
    return h.to("cuda", dtype), W.to("cuda", dtype)


def xent_inputs(rows, H, V, dtype, exact, with_bias, seed):
    """The operands of the fused cross-entropy on the card: h, W (as
    ``head_inputs``), an optional bias, labels with a fifth of the rows on
    PAD (id 0) and zero cotangents there, and non-zero cotangents g_lse,
    g_label, g_sum elsewhere, sized like a mean over 64 captions."""
    h, W = head_inputs(rows, H, V, dtype, exact, seed)
    g = torch.Generator().manual_seed(seed + 100)
    b = None
    if with_bias:
        b = (torch.randint(-8, 9, (V,), generator=g).float() / 16 if exact
             else torch.randn((V,), generator=g) * 0.2).to("cuda", dtype)
    labels = torch.randint(6, V, (rows,), generator=g)
    pad = torch.rand((rows,), generator=g) < 0.2
    labels[pad] = 0
    keep = (~pad).float() / 64
    cot = [keep * (0.9 + 0.2 * torch.rand((rows,), generator=g)),
           -keep * (0.8 + 0.2 * torch.rand((rows,), generator=g)),
           -keep * 0.1 / V * (1 + torch.rand((rows,), generator=g))]
    return h, W, b, labels.cuda(), [c.cuda() for c in cot]


def tie(W):
    """W with every column repeating 37 columns later."""
    return W[torch.arange(W.shape[0], device=W.device) % 37].contiguous()


def max_err(label, what, got, want, rtol, atol):
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    assert torch.allclose(got, want, rtol=rtol, atol=atol), (label, what, err)
    return err


def check_head_case(label, h, W, K, ties_exact, b=None):
    """K1 against its plain version: m and log s within 1e-5 relative +
    1e-6, the top-K values within 1e-4, and the ids equal everywhere
    (``ties_exact``) or else wherever a candidate is separated from both
    its neighbours in the ranking by more than 1e-4."""
    got = fht._stats_cuda(h, W, b, K)
    want = fht._stats_plain(h, W, b, K + 1, 1024)
    torch.cuda.synchronize()
    cv, ids, m, s = (t.cpu() for t in got)
    pv, pi, pm, ps = (t.cpu() for t in want)
    max_err(label, "m", m, pm, 1e-5, 1e-6)
    max_err(label, "log s", s.log(), ps.log(), 1e-5, 1e-6)
    err_cv = (cv - pv[:, :K]).abs().max().item()
    assert err_cv <= 1e-4, (label, err_cv)
    ids = ids.long()
    if ties_exact:
        assert torch.equal(ids, pi[:, :K]), label
    else:
        gap_prev = torch.cat([torch.full((pv.shape[0], 1), float("inf")),
                              pv[:, :K - 1] - pv[:, 1:K]], dim=1)
        gap_next = pv[:, :K] - pv[:, 1:K + 1]
        sep = (gap_prev > 1e-4) & (gap_next > 1e-4)
        assert torch.equal(ids[sep], pi[:, :K][sep]), label


def check_xent_case(label, h, W, b, labels, cot, exact):
    """K2 (forward statistics), K3a (dh) and K3b (dW, db) against their
    plain versions on one set of operands: with ``exact`` operands the
    argmax, maximum, label logit and sum bit for bit, else the argmax where
    the top logit is separated by more than 1e-4, maximum and label logit
    within 1e-5, the sum within 1e-4 relative + 1e-3; lse within 1e-5; dh,
    dW and db within rtol 1e-4 + atol 2e-7 in f32 (summation order, expf)
    and 2**-6 + 1e-4 in bf16 (an ulp of exp can flip the bf16 rounding of a
    dlogits entry, and the outputs are rounded to bf16); PAD rows' dh
    exactly 0."""
    got = fht._argmax_lse_cuda(h, W, b, labels, True)
    want = fht._argmax_lse_plain(h, W, b, labels, 1024, True)
    torch.cuda.synchronize()
    amax = got[0].long()
    if exact:
        assert torch.equal(amax, want[0]), label
        for k, what in ((1, "max"), (3, "label logit"), (4, "sum")):
            assert torch.equal(got[k], want[k]), (label, what)
    else:
        top2 = fht._logits(h, W, b).topk(2, dim=-1).values
        sep = top2[:, 0] - top2[:, 1] > 1e-4
        assert torch.equal(amax[sep], want[0][sep]), label
        max_err(label, "max", got[1], want[1], 1e-5, 1e-5)
        max_err(label, "label logit", got[3], want[3], 1e-5, 1e-5)
        max_err(label, "sum", got[4], want[4], 1e-4, 1e-3)
    max_err(label, "lse", got[2], want[2], 1e-5, 1e-5)

    lse = want[2]
    gdh, gdw, gdb = fx._bwd_cuda(h, W, b, labels, lse, *cot)
    wdh, wdw, wdb = fx._bwd_plain(h, W, b, labels, lse, *cot, 1024)
    torch.cuda.synchronize()
    rtol, atol = (1e-4, 2e-7) if h.dtype == f32 else (2 ** -6, 1e-4)
    max_err(label, "dh", gdh, wdh, rtol, atol)
    max_err(label, "dW", gdw, wdw, rtol, atol)
    max_err(label, "db", gdb, wdb, rtol, atol)
    assert gdh.dtype == h.dtype and gdw.dtype == W.dtype
    pad = labels == 0
    if pad.any():
        assert float(gdh[pad].float().abs().max()) == 0.0, label


def flash_inputs(shape, dtype, bias_kind, seed):
    """q, k, v, do on the card and a bias of the given kind: ``hybrid``
    [1, H, 1, Lk] with a -1e9 tail, ``pad`` [B, 1, 1, Lk] with -1e9 tails of
    different lengths, ``rpe`` [1, H, Lq, Lk], ``masked`` (as ``pad``, with
    every key of instance 0 masked) or None. bf16 inputs are small dyadic
    numbers, exact in bf16."""
    b, h, lq, lk, dh = shape
    g = torch.Generator().manual_seed(seed)
    if dtype == bf16:
        q, k, v, do = (torch.randint(-4, 5, (b, h, n, dh), generator=g).float()
                       / 8 for n in (lq, lk, lk, lq))
    else:
        q, k, v, do = (torch.randn((b, h, n, dh), generator=g)
                       for n in (lq, lk, lk, lq))
    bias = None
    if bias_kind == "hybrid":
        bias = torch.randn((1, h, 1, lk), generator=g) * 0.5
        bias[..., -lk // 4:] = -1e9
    elif bias_kind in ("pad", "masked"):
        bias = torch.zeros((b, 1, 1, lk))
        for n in range(b):
            bias[n, ..., lk - 1 - (n * 7) % (lk // 2):] = -1e9
        if bias_kind == "masked":
            bias[0] = -1e9
    elif bias_kind == "rpe":
        bias = torch.randn((1, h, lq, lk), generator=g) * 0.5
    return ([t.to("cuda", dtype) for t in (q, k, v, do)],
            None if bias is None else bias.cuda())


def check_flash_case(label, shape, dtype, bias_kind, seed):
    """K4a against its plain version and the dense attention; then the
    gradients of ``flash_attention(backward="kernel")`` (K4b, K4c, one
    launch each; a query-extent bias takes the dense rule and launches
    neither) against the plain backward and against autograd of the dense
    attention. f32 within rtol 1e-4 + atol 2e-5 (out) and 1e-4 + 1e-4
    (gradients): the key tiles are summed in another order and expf is not
    torch.exp; bf16 within 2**-6 + 2e-2 and 2**-5 + 5e-2: an ulp of exp can
    flip the bf16 rounding of a weight, and the outputs are themselves
    rounded to bf16. A row whose keys are all masked has lse = -1e9 +
    log(Lk), which f32 rounds to -1e9, so the recomputed weights of that
    row are 1 and not 1/Lk, in the kernels as in the TPU kernels they
    replace: the ``masked`` case holds its gradients against the plain
    backward only."""
    (q, k, v, do), bias = flash_inputs(shape, dtype, bias_kind, seed)
    tol = dict(rtol=1e-4, atol=2e-5) if dtype == f32 else dict(
        rtol=2**-6, atol=2e-2)
    gtol = dict(rtol=1e-4, atol=1e-4) if dtype == f32 else dict(
        rtol=2**-5, atol=5e-2)
    out, lse = fa._flash_fwd_cuda(q, k, v, bias)
    want, want_lse = fa._flash_fwd_plain(q, k, v, bias)
    dense, _ = dot_product_attention(q, k, v, bias=bias, return_probs=False)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    assert torch.isfinite(out.float()).all(), label
    max_err(label, "out vs plain", out, want, **tol)
    max_err(label, "out vs dense", out, dense, **tol)
    max_err(label, "lse", lse, want_lse, 1e-5, 2e-5)

    launches = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.clone().requires_grad_(True))
    leaf_bias = leaves[3] if bias is not None else None
    got = torch.autograd.grad(
        fa.flash_attention(*leaves[:3], bias=leaf_bias, backward="kernel"),
        leaves, do)
    kernel_rule = bias_kind != "rpe"
    assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (
        launches[0] + 1, launches[1] + kernel_rule,
        launches[2] + kernel_rule), label
    dense_out, _ = dot_product_attention(*leaves[:3], bias=leaf_bias,
                                         return_probs=False)
    want_dense = torch.autograd.grad(dense_out, leaves, do)
    names = ("dq", "dk", "dv", "dbias")
    for name, a, d in zip(names, got, want_dense):
        assert a.shape == d.shape and a.dtype == d.dtype, (label, name)
        if bias_kind != "masked":
            max_err(label, name + " vs dense autograd", a, d, **gtol)
    if kernel_rule:
        delta = (do.float() * want.float()).sum(-1)
        plain = fa._flash_bwd_plain(q, k, v, bias, want_lse, do, delta)
        for name, a, p in zip(names, got, plain):
            if p is not None:
                p = fa._unbroadcast(p, a.shape) if name == "dbias" else p
                max_err(label, name + " vs plain", a, p, **gtol)
    torch.cuda.synchronize()


def bookkeeping_state(N, K, topk, t, mode, seed, vocab, length,
                      device="cpu"):
    """(best_scores, best_ids, state) of beam step ``t`` of N instances at
    beam K, ``topk`` finished slots (the capacity is ``max(K, topk)``),
    ``vocab`` words and histories of ``length`` columns. ``mode``:
    ``mixed``, random EOS rows and counts; ``fills``, one slot left and at
    least two EOS rows where the beam has them; ``full``, no slot left. The
    top-k's scores sit in rows of a wider tensor, as ``top_k`` returns
    them; ids are over the flat ``k * vocab + v`` space."""
    rs = np.random.RandomState(seed)
    Fb = max(K, topk)
    new_tok = rs.randint(4, vocab, (N, K))
    if mode == "mixed":
        new_tok[rs.rand(N, K) < 0.4] = constants.EOS
        count = rs.randint(0, Fb + 1, N)
    else:
        for n in range(N):
            new_tok[n, rs.choice(K, min(K, rs.randint(2, 5)),
                                 replace=False)] = constants.EOS
        count = np.full(N, Fb - 1 if mode == "fills" else Fb)
    prev_k = rs.randint(0, K, (N, K))
    wide = rs.randn(N, 2 * K).astype(np.float32)
    as_t = lambda a, dtype=torch.long: torch.as_tensor(a, dtype=dtype,
                                                      device=device)
    state = dict(
        tokens=as_t(rs.randint(0, vocab, (N, K, length))),
        scores=as_t(rs.randn(N, K), torch.float32),
        last_tokens=as_t(rs.randint(0, vocab, (N, K))),
        fin_scores=as_t(rs.randn(N, Fb), torch.float32),
        fin_lengths=as_t(rs.randint(1, length, (N, Fb))),
        fin_tokens=as_t(rs.randint(0, vocab, (N, Fb, length))),
        fin_count=as_t(count))
    best_scores = as_t(wide, torch.float32)[:, :K]
    return best_scores, as_t(prev_k * vocab + new_tok), state


def check_bookkeeping(case, seed, vocab, length):
    """The bookkeeping kernel against ``beam_bookkeeping_plain`` on one
    state of ``bookkeeping_state`` on the card, ``case`` being (N, K,
    topk, t, mode): one launch, and the carry's row index and every state
    tensor bit for bit (each value is a copy or integer arithmetic)."""
    best_scores, best_ids, state = bookkeeping_state(
        *case, seed=seed, vocab=vocab, length=length, device="cuda")
    plain = {k: v.clone() for k, v in state.items()}
    t = case[3]
    launches = bb.launches
    got = bb.beam_bookkeeping(best_scores, best_ids, vocab, t,
                              constants.EOS, **state)
    assert bb.launches == launches + 1, case
    want = bb.beam_bookkeeping_plain(best_scores, best_ids, vocab, t,
                                     constants.EOS, **plain)
    torch.cuda.synchronize()
    assert torch.equal(got, want), case
    for name, x in state.items():
        assert torch.equal(x, plain[name]), (case, name)
