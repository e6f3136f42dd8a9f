"""The port's ``flash_attention`` (``care_tpu_torch/ops/flash_attention.py``)
against the JAX package's, run as its own tests run it on the CPU (the
Pallas kernels in interpret mode), and against both packages' dense
``dot_product_attention``: the cases of ``tests/test_flash_attention.py`` one
for one, plus the decode shape in small and a row whose keys are all masked.

On the CPU the port runs its plain versions, block by block with the online
softmax. Tolerances are the JAX suite's own: atol 2e-5, rtol 1e-4 forward;
atol 3e-5, rtol 1e-4 gradients (the sums are taken blockwise, in another
order than the dense softmax's).

The ``gpu``-marked test holds the CUDA kernels against their plain versions
on a card, where the JAX package does not import: the JAX side is imported
inside the helpers that use it.
"""

import numpy as np
import pytest
import torch

from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops.attention import dot_product_attention

FWD = dict(atol=2e-5, rtol=1e-4)
GRAD = dict(atol=3e-5, rtol=1e-4)
RULES = {"kernel": "pallas", "dense": "xla", "auto": "auto"}


def _qkv(rs, b, h, lq, lk, dh):
    return [rs.randn(b, h, n, dh).astype(np.float32) for n in (lq, lk, lk)]


def _port_forward(q, k, v, bias=None, **kw):
    args = [torch.as_tensor(x) for x in (q, k, v)]
    bias = None if bias is None else torch.as_tensor(bias)
    with torch.no_grad():
        out = fa.flash_attention(*args, bias=bias, **kw)
        dense, _ = dot_product_attention(*args, bias=bias, return_probs=False)
    return out.numpy(), dense.numpy()


def jax_flash_attention(*args, **kw):
    from care_tpu.ops.pallas.flash_attention import flash_attention
    return flash_attention(*args, **kw)


def jax_attention(*args, **kw):
    from care_tpu.ops.attention import dot_product_attention
    return dot_product_attention(*args, **kw)


def _check_forward(q, k, v, bias=None, **kw):
    import jax.numpy as jnp
    out, dense = _port_forward(q, k, v, bias, **kw)
    jbias = None if bias is None else jnp.asarray(bias)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)), bias=jbias,
                               interpret=True)
    ref, _ = jax_attention(*map(jnp.asarray, (q, k, v)), bias=jbias,
                           return_probs=False)
    assert out.shape == q.shape and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(want), **FWD)
    np.testing.assert_allclose(out, np.asarray(ref), **FWD)
    np.testing.assert_allclose(out, dense, **FWD)


@pytest.mark.parametrize("lq,lk", [(128, 128), (100, 200), (37, 1568)])
def test_flash_matches_jax_and_dense(lq, lk):
    rs = np.random.RandomState(0)
    b, h, dh = 2, 2, 32
    q, k, v = _qkv(rs, b, h, lq, lk, dh)
    # pad mask on the last quarter of the keys + a smooth learned-bias term
    bias = rs.randn(1, h, 1, lk).astype(np.float32) * 0.5
    bias[..., -lk // 4:] = -1e9
    _check_forward(q, k, v, bias)
    # the JAX tests hand the kernel the bias already broadcast
    _check_forward(q, k, v, np.broadcast_to(bias, (b, h, lq, lk)).copy())


def test_flash_no_bias():
    rs = np.random.RandomState(1)
    _check_forward(*_qkv(rs, 1, 4, 64, 96, 16))


def test_flash_decode_shape_in_small():
    """The beam-grouped decode step: 5 query rows against 1654 keys, the
    hybrid bias [1, H, 1, Lk]; ragged blocks in both axes."""
    rs = np.random.RandomState(2)
    q, k, v = _qkv(rs, 3, 2, 5, 1654, 16)
    bias = rs.randn(1, 2, 1, 1654).astype(np.float32) * 0.3
    _check_forward(q, k, v, bias)
    _check_forward(q, k, v, bias, block_q=4, block_k=100)


def test_flash_all_masked_row_matches_dense_softmax():
    """Every key of instance 0 carries the -1e9 mask: the running maximum
    starts at -1e9, so the row gets the dense softmax's (nearly uniform)
    weights, not zeros and not NaN."""
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 2, 2, 6, 40, 8)
    bias = np.zeros((2, 1, 1, 40), np.float32)
    bias[0] = -1e9
    bias[1, ..., 30:] = -1e9
    out, dense = _port_forward(q, k, v, bias, block_k=16)
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, dense, **FWD)
    np.testing.assert_allclose(out[0], np.broadcast_to(
        v[0].mean(axis=1, keepdims=True), out[0].shape), **FWD)
    import jax.numpy as jnp
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                               bias=jnp.asarray(bias), interpret=True,
                               block_k=8)
    np.testing.assert_allclose(out, np.asarray(want), **FWD)


def _split_case(name):
    """q, k, v, bias and the plain forward's key block of one key-split
    case: head widths 32 and 128 with a -1e9 tail, where 4 and 8 splits
    leave runs of key blocks wholly past Lk; and the all-masked instance."""
    rs = np.random.RandomState(11)
    if name == "all masked":
        q, k, v = _qkv(rs, 2, 2, 6, 40, 8)
        bias = np.zeros((2, 1, 1, 40), np.float32)
        bias[0] = -1e9
        bias[1, ..., 30:] = -1e9
        return q, k, v, bias, 16
    dh, lq, lk = (32, 5, 40) if name == "Dh 32" else (128, 7, 70)
    q, k, v = _qkv(rs, 2, 2, lq, lk, dh)
    bias = rs.randn(1, 2, 1, lk).astype(np.float32) * 0.5
    bias[..., -lk // 4:] = -1e9
    return q, k, v, bias, 16


@pytest.mark.parametrize("name", ["Dh 32", "Dh 128", "all masked"])
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_flash_key_splits_match_jax(name, splits):
    """``_flash_fwd_plain(..., key_splits=s)``, the forward kernel's split of
    the keys over a cluster of blocks and its merge in order, against the
    JAX package's forward and the dense attention; its lse against the
    unsplit one. A run of key blocks wholly past Lk weighs nothing, and the
    all-masked instance keeps the dense softmax's near-uniform weights."""
    import jax.numpy as jnp
    q, k, v, bias, block_k = _split_case(name)
    args = [torch.as_tensor(x) for x in (q, k, v, bias)]
    out, lse = fa._flash_fwd_plain(*args, block_k=block_k, key_splits=splits)
    _, want_lse = fa._flash_fwd_plain(*args, block_k=block_k)
    # runs of ceil(blocks / splits) key blocks: from 4 splits on, the last
    # runs hold no key at all
    n_blocks = -(-k.shape[2] // block_k)
    per = -(-n_blocks // splits)
    assert (splits - -(-n_blocks // per) > 0) == (splits >= 4)
    want = jax_flash_attention(*map(jnp.asarray, (q, k, v)),
                               bias=jnp.asarray(bias), interpret=True,
                               block_k=8)
    dense, _ = dot_product_attention(*args, return_probs=False)
    out = out.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(want), **FWD)
    np.testing.assert_allclose(out, dense.numpy(), **FWD)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), rtol=1e-5,
                               atol=2e-5)
    if name == "all masked":
        np.testing.assert_allclose(out[0], np.broadcast_to(
            v[0].mean(axis=1, keepdims=True), out[0].shape), **FWD)


def _port_grads(q, k, v, bias, weight, wrt, **kw):
    leaves = [torch.as_tensor(x).requires_grad_(True)
              for x in (q, k, v) + (() if bias is None else (bias,))]
    out = fa.flash_attention(*leaves[:3],
                             bias=None if bias is None else leaves[3], **kw)
    loss = (out * torch.as_tensor(weight)).sum()
    grads = torch.autograd.grad(loss, [leaves[i] for i in wrt])
    return [g.numpy() for g in grads]


def _jax_grads(fn, q, k, v, bias, weight, wrt):
    import jax
    import jax.numpy as jnp

    def loss(q, k, v, bias):
        return (fn(q, k, v, bias) * weight).sum()
    args = [jnp.asarray(x) for x in (q, k, v)] + [
        None if bias is None else jnp.asarray(bias)]
    return [np.asarray(g) for g in jax.grad(loss, argnums=wrt)(*args)]


def _check_grads(q, k, v, bias, wrt, rule, **blocks):
    weight = np.arange(q.shape[-1], dtype=np.float32)
    got = _port_grads(q, k, v, bias, weight, wrt, backward=rule, **blocks)
    flash = _jax_grads(
        lambda q, k, v, b: jax_flash_attention(
            q, k, v, bias=b, interpret=True, backward=RULES[rule], **blocks),
        q, k, v, bias, weight, wrt)
    dense = _jax_grads(
        lambda q, k, v, b: jax_attention(q, k, v, bias=b,
                                         return_probs=False)[0],
        q, k, v, bias, weight, wrt)
    for g, f, d, i in zip(got, flash, dense, wrt):
        assert g.shape == (q, k, v, bias)[i].shape   # incl. the unbroadcast
        np.testing.assert_allclose(g, f, **GRAD)
        np.testing.assert_allclose(g, d, **GRAD)
    return got


def test_flash_gradients_match_jax():
    """q, k, v and the [1, H, 1, Lk] hybrid-bias gradient through the
    kernel rule."""
    rs = np.random.RandomState(3)
    q, k, v = _qkv(rs, 2, 2, 24, 40, 16)
    bias = rs.randn(1, 2, 1, 40).astype(np.float32) * 0.3
    _check_grads(q, k, v, bias, (0, 1, 2, 3), "kernel")


def test_flash_gradients_no_bias():
    rs = np.random.RandomState(4)
    q, k, v = _qkv(rs, 1, 2, 16, 24, 8)
    _check_grads(q, k, v, None, (0, 1, 2), "kernel")


def test_flash_gradients_query_extent_bias_takes_dense_rule(monkeypatch):
    """A [1, H, Lq, Lk] bias (relative-position tables) needs the full bias
    gradient: the dense rule, whatever ``backward`` says."""
    rs = np.random.RandomState(5)
    q, k, v = _qkv(rs, 1, 2, 12, 20, 8)
    bias = rs.randn(1, 2, 12, 20).astype(np.float32) * 0.3

    def no_kernel_rule(*args, **kwargs):
        raise AssertionError("the kernel rule ran on a query-extent bias")
    monkeypatch.setattr(fa, "_flash_bwd_plain", no_kernel_rule)
    for rule in ("auto", "kernel"):
        _check_grads(q, k, v, bias, (0, 1, 2, 3), rule)


def test_flash_gradients_pad_mask_bias_ragged_blocks():
    """The [B, 1, 1, Lk] pad-mask bias through the kernel rule with blocks
    that leave ragged last blocks, incl. the unbroadcast over the heads."""
    rs = np.random.RandomState(6)
    q, k, v = _qkv(rs, 2, 2, 40, 72, 16)
    bias = rs.randn(2, 1, 1, 72).astype(np.float32)
    _check_grads(q, k, v, bias, (0, 1, 2, 3), "kernel", block_q=16,
                 block_k=32)


def test_flash_backward_rules_agree():
    """``auto`` (the dense rule at this size), ``kernel`` and ``dense``."""
    rs = np.random.RandomState(7)
    q, k, v = _qkv(rs, 1, 2, 16, 24, 8)
    bias = rs.randn(1, 2, 1, 24).astype(np.float32)
    got = {rule: _check_grads(q, k, v, bias, (0, 3), rule) for rule in RULES}
    for a, d in zip(got["auto"], got["dense"]):
        np.testing.assert_array_equal(a, d)


def test_flash_auto_rule_switches_on_the_probabilities_size(monkeypatch):
    rs = np.random.RandomState(8)
    q, k, v = _qkv(rs, 1, 2, 16, 24, 8)
    weight = np.ones(8, np.float32)
    calls = []
    plain = fa._flash_bwd_plain
    monkeypatch.setattr(fa, "_flash_bwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    _port_grads(q, k, v, None, weight, (0,), backward="auto")
    assert not calls
    monkeypatch.setattr(fa, "_BWD_KERNEL_MIN_BYTES", 1 * 2 * 16 * 24 * 4 - 1)
    _port_grads(q, k, v, None, weight, (0,), backward="auto")
    assert calls == [1]


def test_flash_lower_rank_bias_and_unbroadcast():
    """A bias of rank 2 ([1, Lk]) broadcasts like the JAX package's, and its
    gradient comes back in its own shape."""
    rs = np.random.RandomState(9)
    q, k, v = _qkv(rs, 2, 2, 10, 12, 8)
    bias = rs.randn(1, 12).astype(np.float32)
    _check_grads(q, k, v, bias, (3,), "kernel", block_q=8, block_k=8)


def test_flash_bf16_rounds_like_the_kernel_rule():
    """bf16 inputs: f32 accumulation, the weights rounded to bf16 before
    ``p @ v``; against the dense attention on the same bf16 values."""
    rs = np.random.RandomState(10)
    q, k, v = (torch.as_tensor(x).bfloat16() for x in _qkv(rs, 1, 2, 9, 50, 16))
    out = fa.flash_attention(q, k, v, block_k=16)
    assert out.dtype == torch.bfloat16
    dense, _ = dot_product_attention(q, k, v, return_probs=False)
    np.testing.assert_allclose(out.float().numpy(), dense.float().numpy(),
                               atol=2e-2, rtol=2e-2)


def test_flash_rejects_what_it_does_not_take():
    q = torch.zeros(1, 1, 2, 8)
    with pytest.raises(ValueError, match="backward"):
        fa.flash_attention(q, q, q, backward="pallas")
    cuda_like = torch.zeros(1, 1, 2, 24)
    with pytest.raises(ValueError, match="head width"):
        fa._check_operands(cuda_like, cuda_like, cuda_like, None, True)
    with pytest.raises(TypeError, match="f32 or bf16"):
        fa._check_operands(*[cuda_like.double()] * 3, None, True)
    wide = torch.zeros(1, 1, 2, 32)
    strided = torch.zeros(1, 1, 32, 2).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        fa._check_operands(wide, strided, strided, None, True)
    with pytest.raises(ValueError, match="query extent"):
        fa._check_operands(wide, wide, wide, torch.zeros(1, 1, 2, 2), False)


@pytest.mark.gpu
def test_flash_kernels_match_plain_on_the_card():
    """K4a, K4b and K4c against their plain versions on a CUDA card: the
    decode shape in small, ragged tiles, bf16 at head widths 64 and 128,
    the ragged decode batch of 17 whose keys K4a splits over a cluster of
    blocks (f32 and bf16, head widths 32, 64, 128), and gradients through
    ``backward="kernel"`` with every launch counted; a second call of each
    kernel on the same operands repeats bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    cases = [((3, 2, 5, 1654, 64), torch.float32),
             ((2, 2, 37, 1568, 32), torch.float32),
             ((2, 2, 100, 200, 128), torch.float32),
             ((2, 2, 70, 130, 64), torch.bfloat16),
             ((2, 2, 70, 130, 128), torch.bfloat16)]
    cases += [((17, 8, 5, 1654, dh), dtype) for dh in (32, 64, 128)
              for dtype in (torch.float32, torch.bfloat16)]
    for (b, h, lq, lk, dh), dtype in cases:
        q, k, v, do = (torch.randn((b, h, n, dh), generator=g).to(
            "cuda", dtype) for n in (lq, lk, lk, lq))
        bias = (torch.randn((1, h, 1, lk), generator=g) * 0.5).cuda()
        bias[..., -lk // 4:] = -1e9
        counts = (fa.fwd_launches, fa.dq_launches, fa.dkv_launches)
        out, lse = fa._flash_fwd_cuda(q, k, v, bias)
        want, want_lse = fa._flash_fwd_plain(q, k, v, bias)
        if b == 17:
            assert fa.fwd_key_splits(q, k) > 1
        again = fa._flash_fwd_cuda(q, k, v, bias)
        assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
        tol = (dict(atol=2e-5, rtol=1e-4) if dtype == torch.float32
               else dict(atol=2e-2, rtol=2e-2))
        torch.testing.assert_close(out.float(), want.float(), **tol)
        torch.testing.assert_close(lse, want_lse, atol=2e-5, rtol=1e-5)
        delta = (do.float() * want.float()).sum(-1)
        got = fa._flash_bwd_cuda(q, k, v, bias, want_lse, do, delta)
        ref = fa._flash_bwd_plain(q, k, v, bias, want_lse, do, delta)
        gtol = (dict(atol=1e-4, rtol=1e-4) if dtype == torch.float32
                else dict(atol=5e-2, rtol=5e-2))
        for a, r in zip(got, ref):
            torch.testing.assert_close(a.float(), r.float(), **gtol)
        assert (fa.fwd_launches, fa.dq_launches, fa.dkv_launches) == (
            counts[0] + 2, counts[1] + 1, counts[2] + 1)
        again = fa._flash_bwd_cuda(q, k, v, bias, want_lse, do, delta)
        assert all(torch.equal(a, r) for a, r in zip(got, again))
