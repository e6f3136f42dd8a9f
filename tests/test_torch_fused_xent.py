"""The port's fused cross-entropy statistics (``care_tpu_torch.ops.fused_xent``
and ``vocab_argmax_lse``) against the JAX package's, values and gradients.

On the CPU the port runs the plain versions of its kernels; the JAX side
runs its ``lax.scan`` form (``backend="xla"``) and its Pallas kernels in
interpret mode. Inputs come from numpy seeds; f32 on both sides. The port's
``W`` is ``[V, H]``, the JAX package's ``[H, V]``. Tolerances are those of
``tests/test_fused_xent.py``: 1e-5 absolute on lse and label logit, 1e-5
relative on the sum, equal argmax; gradients 2e-5 relative + 2e-6
absolute (summation order differs between the chunked forms).

The ``gpu``-marked test holds the CUDA kernels against the plain versions
on a card; it imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.ops import fused_xent as fx

GRID = [(96, 32), (200, 64), (217, 64)]


def _inputs(seed, B, L, H, V, with_bias):
    rng = np.random.RandomState(seed)
    h = rng.randn(B, L, H).astype(np.float32)
    W = (rng.randn(H, V) * 0.2).astype(np.float32)          # JAX layout
    b = (rng.randn(V) * 0.2).astype(np.float32) if with_bias else None
    labels = rng.randint(0, V, (B, L)).astype(np.int32)
    return h, W, b, labels


def _port_args(h, W, b, labels, grad=False):
    th = torch.tensor(h, requires_grad=grad)
    tW = torch.tensor(np.ascontiguousarray(W.T), requires_grad=grad)
    tb = None if b is None else torch.tensor(b, requires_grad=grad)
    return th, tW, tb, torch.tensor(labels, dtype=torch.long)


def _dense(h, W, b, labels):
    logits = h.astype(np.float64) @ W.astype(np.float64)
    if b is not None:
        logits = logits + b
    m = logits.max(-1, keepdims=True)
    lse = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    lab = np.take_along_axis(logits, labels[..., None].astype(np.int64),
                             -1)[..., 0]
    return lse, lab, logits.sum(-1), logits.argmax(-1), logits.max(-1)


def _jax_stats(h, W, b, labels, chunk, backend):
    import jax.numpy as jnp
    from care_tpu.ops.fused_xent import vocab_xent_stats
    out = vocab_xent_stats(
        jnp.asarray(h), jnp.asarray(W), None if b is None else jnp.asarray(b),
        jnp.asarray(labels), chunk, backend, 8, backend == "pallas")
    return [np.array(o) for o in out]


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("V,chunk", GRID)
@pytest.mark.parametrize("with_bias", [False, True])
def test_forward_matches_jax_and_dense(V, chunk, with_bias, backend):
    h, W, b, labels = _inputs(0, 3, 5, 16, V, with_bias)
    with torch.no_grad():
        got = [t.numpy() for t in fx.vocab_xent_stats(
            *_port_args(h, W, b, labels), chunk)]
    assert all(g.shape == labels.shape for g in got)
    for want in (_jax_stats(h, W, b, labels, chunk, backend),
                 _dense(h, W, b, labels)[:4]):
        np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=1e-5)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(got[3], want[3])


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("with_bias", [False, True])
def test_gradients_match_jax_and_dense(with_bias, backend):
    import jax
    import jax.numpy as jnp
    from care_tpu.ops.fused_xent import vocab_xent_stats as jax_stats

    B, L, H, V, chunk = 2, 4, 12, 150, 64
    h, W, b, labels = _inputs(1, B, L, H, V, with_bias)
    # the language-loss shape: smoothed CE summed with a position mask, so
    # all three cotangents (lse, label, sum) are non-zero
    mask = (np.random.RandomState(2).rand(B, L) > 0.3).astype(np.float32)
    eps = 0.1

    def jax_loss(h, W, b):
        lse, lab, tot, _ = jax_stats(h, W, b, jnp.asarray(labels), chunk,
                                     backend, 8, backend == "pallas")
        return jnp.sum(((1 - eps) * (lse - lab) + eps * (lse - tot / V))
                       * mask)

    argnums = (0, 1, 2) if with_bias else (0, 1)
    jl, jg = jax.value_and_grad(jax_loss, argnums)(
        jnp.asarray(h), jnp.asarray(W),
        jnp.asarray(b) if with_bias else None)

    def port_loss(fused):
        th, tW, tb, tl = _port_args(h, W, b, labels, grad=True)
        tm = torch.tensor(mask)
        if fused:
            lse, lab, tot, _ = fx.vocab_xent_stats(th, tW, tb, tl, chunk)
            nll, smooth = lse - lab, lse - tot / V
        else:
            logits = th @ tW.t() + (tb if tb is not None else 0.0)
            logp = torch.log_softmax(logits, dim=-1)
            nll = -torch.gather(logp, 2, tl[..., None])[..., 0]
            smooth = -logp.mean(-1)
        loss = (((1 - eps) * nll + eps * smooth) * tm).sum()
        loss.backward()
        grads = [th.grad.numpy(), tW.grad.numpy().T]
        if with_bias:
            grads.append(tb.grad.numpy())
        return loss.item(), grads

    fl, fg = port_loss(True)
    dl, dg = port_loss(False)
    np.testing.assert_allclose(fl, float(jl), rtol=1e-6)
    np.testing.assert_allclose(fl, dl, rtol=1e-6)
    for a, j, d in zip(fg, jg, dg):
        np.testing.assert_allclose(a, np.array(j), rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(a, d, rtol=2e-5, atol=2e-6)


def test_needs_input_grad_is_honoured():
    h, W, b, labels = _inputs(3, 2, 3, 8, 70, True)
    th, tW, tb, tl = _port_args(h, W, b, labels)
    th.requires_grad_(True)
    lse, lab, tot, amax = fx.vocab_xent_stats(th, tW, tb, tl, 32)
    assert not amax.requires_grad and amax.dtype == torch.long
    (lse - lab).sum().backward()
    assert th.grad is not None and tW.grad is None and tb.grad is None


def test_argmax_tie_breaks_lowest_index_across_chunks():
    H, V, chunk = 4, 128, 32
    W = np.zeros((H, V), np.float32)
    W[:, 10] = 0.5
    W[:, 97] = 0.5                       # same column, another chunk
    h = np.ones((1, H), np.float32)
    labels = np.zeros((1,), np.int32)
    th, tW, _, tl = _port_args(h, W, None, labels)
    assert int(fx.vocab_xent_stats(th, tW, None, tl, chunk)[3][0]) == 10
    assert int(fht.vocab_argmax_lse(th, tW, None, None, chunk)[0][0]) == 10
    assert int(_jax_stats(h, W, None, labels, chunk, "xla")[3][0]) == 10


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("V,chunk", GRID)
@pytest.mark.parametrize("with_bias,with_tokens",
                         [(False, False), (True, True)])
def test_vocab_argmax_lse_matches_jax(V, chunk, with_bias, with_tokens,
                                      backend):
    import jax.numpy as jnp
    from care_tpu.ops.fused_head_topk import vocab_argmax_lse as jax_fn

    h, W, b, tokens = _inputs(4, 3, 5, 16, V, with_bias)
    want = jax_fn(jnp.asarray(h), jnp.asarray(W),
                  None if b is None else jnp.asarray(b),
                  jnp.asarray(tokens) if with_tokens else None,
                  chunk_size=chunk, backend=backend, block_rows=8,
                  interpret=backend == "pallas")
    th, tW, tb, tt = _port_args(h, W, b, tokens)
    got = fht.vocab_argmax_lse(th, tW, tb, tt if with_tokens else None, chunk)
    assert len(got) == len(want) == (4 if with_tokens else 3)
    dense = _dense(h, W, b, tokens)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want[0]))
    np.testing.assert_array_equal(got[0].numpy(), dense[3])
    np.testing.assert_allclose(got[1].numpy(), np.array(want[1]), atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), dense[4], atol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), np.array(want[2]), atol=1e-5)
    if with_tokens:
        np.testing.assert_allclose(got[3].numpy(), np.array(want[3]),
                                   atol=1e-5)
        np.testing.assert_allclose(got[3].numpy(), dense[1], atol=1e-5)


def test_bf16_rounds_like_the_kernel_states():
    """bf16 inputs: f32 accumulation, rounded to bf16, bias added in bf16.
    XLA on the CPU keeps excess precision there, so the comparison uses
    dyadic inputs on which every rounding is exact."""
    import jax.numpy as jnp
    from care_tpu.ops.fused_head_topk import vocab_argmax_lse as jax_fn

    rng = np.random.RandomState(5)
    h = (rng.randint(-4, 5, (6, 16)) / 4).astype(np.float32)
    W = (rng.randint(-4, 5, (16, 100)) / 8).astype(np.float32)
    b = (rng.randint(-4, 5, (100,)) / 4).astype(np.float32)
    tokens = rng.randint(0, 100, (6,)).astype(np.int32)
    want = jax_fn(jnp.asarray(h, jnp.bfloat16), jnp.asarray(W, jnp.bfloat16),
                  jnp.asarray(b, jnp.bfloat16), jnp.asarray(tokens),
                  chunk_size=32, backend="xla")
    got = fht.vocab_argmax_lse(
        torch.tensor(h).bfloat16(), torch.tensor(W.T.copy()).bfloat16(),
        torch.tensor(b).bfloat16(), torch.tensor(tokens).long(), 32)
    np.testing.assert_array_equal(got[0].numpy(), np.array(want[0]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.array(want[1], np.float32))
    np.testing.assert_allclose(got[2].numpy(), np.array(want[2], np.float32),
                               atol=1e-5)
    np.testing.assert_array_equal(got[3].numpy(),
                                  np.array(want[3], np.float32))


def test_other_devices_raise():
    h = torch.zeros((2, 4), device="meta")
    W = torch.zeros((8, 4), device="meta")
    with pytest.raises(RuntimeError, match="device"):
        fht.argmax_lse_stats(h, W, None, None)


# ---------------------------------------------------------------------------
# the CUDA kernels against the plain versions, on a card
# ---------------------------------------------------------------------------

def _card_case(rows, H, V, dtype, with_bias, seed):
    g = torch.Generator().manual_seed(seed)
    h = torch.randn((rows, H), generator=g)
    W = (torch.rand((V, H), generator=g) * 2 - 1) * (6 / (H + V)) ** 0.5
    b = torch.randn((V,), generator=g) * 0.2 if with_bias else None
    labels = torch.randint(0, V, (rows,), generator=g)
    cot = [torch.randn((rows,), generator=g) for _ in range(3)]
    cot[2] = cot[2] * 1e-2
    to = lambda t: None if t is None else t.to("cuda", dtype)
    return (to(h), to(W), to(b), labels.cuda(),
            [c.cuda() for c in cot])


@pytest.mark.gpu
def test_cuda_kernels_match_plain_versions():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    for rows, V, with_bias in ((493, 1100, True), (128, 257, False)):
        h, W, b, labels, (gl, gb, gs) = _card_case(rows, 64, V, torch.float32,
                                                   with_bias, rows)
        got = fht._argmax_lse_cuda(h, W, b, labels, True)
        want = fht._argmax_lse_plain(h, W, b, labels, 1024, True)
        torch.cuda.synchronize()
        assert torch.equal(got[0].long(), want[0])
        for g, w in zip(got[1:], want[1:]):
            # summation order differs (tiles of 128 against chunks of 1024)
            torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)
        lse = want[2]
        got = fx._bwd_cuda(h, W, b, labels, lse, gl, gb, gs)
        want = fx._bwd_plain(h, W, b, labels, lse, gl, gb, gs, 1024)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-5)
    # through autograd: the wrapper launches each kernel once
    h.requires_grad_(True)
    W.requires_grad_(True)
    before = (fht.argmax_lse_launches, fx.dh_launches, fx.dw_launches)
    lse, lab, tot, _ = fx.vocab_xent_stats(h, W, None, labels)
    (lse - lab + 0.01 * tot).sum().backward()
    torch.cuda.synchronize()
    after = (fht.argmax_lse_launches, fx.dh_launches, fx.dw_launches)
    assert tuple(a - b for a, b in zip(after, before)) == (1, 1, 1)
    assert h.grad.shape == h.shape and W.grad.shape == W.shape


def _chip_smoke():
    """``chip_smoke.py``, whose operand makers and checks the ``gpu`` tests
    share; imported only once a card is there."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    import chip_smoke
    return chip_smoke


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows,H", [(320, 512), (85, 512), (85, 576),
                                    (85, 768), (85, 1024)])
def test_kernels_match_plain_at_width(rows, H, with_bias, dtype):
    """K2, K3a and K3b against the plain versions through ``chip_smoke.py``'s
    check (K2: lse within 1e-5; K3a and K3b: dh and dW within rtol 1e-4 +
    atol 2e-7 in f32, 2**-6 + 1e-4 in bf16), at a V (10997) that is a
    multiple of no tile. H 512 is the flagship's; 576 the widest f32 head
    whose tiles the three kernels keep resident; 768 and 1024 (the
    ``median`` and ``large`` presets) take their streaming variants in f32
    and, in K3a and K3b, a second slice of dh's or dW's columns in both
    types. Two calls of each kernel repeat bit for bit."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    exact = dtype == torch.bfloat16
    h, W, b, labels, cot = cs._xent_inputs(rows, H, 10997, dtype, exact,
                                           with_bias, rows + H)
    before = (fht.argmax_lse_launches, fx.dh_launches, fx.dw_launches)
    cs._check_xent_case(f"rows {rows} H {H}", h, W, b, labels, cot, exact)
    lse = fht._argmax_lse_plain(h, W, b, labels, 1024, False)[2]
    first, second = (fx._bwd_cuda(h, W, b, labels, lse, *cot)
                     for _ in range(2))
    stats = [fht._argmax_lse_cuda(h, W, b, labels, True) for _ in range(2)]
    torch.cuda.synchronize()
    after = (fht.argmax_lse_launches, fx.dh_launches, fx.dw_launches)
    assert tuple(a - c for a, c in zip(after, before)) == (3, 3, 3)
    assert all(torch.equal(x, y) for x, y in zip(first, second))
    assert all(torch.equal(x, y) for x, y in zip(*stats))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,H", [(200, 512), (85, 768)])
def test_kernel_ties_across_tile_borders(rows, H, dtype):
    """Every vocab column repeats 37 columns later, so equal maxima fall in
    different 64-column tiles, warps and vocab splits of K2 and across the
    row tiles of K3a and K3b (rows 200: four 64-row tiles of K2, seven
    32-row tiles of K3a). Small dyadic operands make every logit exact, so
    the argmax, max, label logit and sum must equal the plain version's bit
    for bit (``chip_smoke.py``'s exact check), dh and dW within their
    tolerances."""
    cs = _chip_smoke()
    torch.backends.cuda.matmul.allow_tf32 = False
    V = 10997
    h, W, b, labels, cot = cs._xent_inputs(rows, H, V, dtype, True, True,
                                           rows + H + 1)
    W = W[torch.arange(V, device="cuda") % 37].contiguous()
    b = b[torch.arange(V, device="cuda") % 37].contiguous()
    cs._check_xent_case(f"ties rows {rows} H {H}", h, W, b, labels, cot, True)


@pytest.mark.gpu
def test_fused_train_steps_at_median_width():
    """``Trainer.fit`` on the card with ``fused_xent`` on, at the ``median``
    preset's H 768 in f32 (K3b's streaming variant): K3b launches once a
    step, and the losses follow the dense step's from the same seed, step 0
    within 1e-5 relative, the next within 1e-3 (``chip_smoke.py``'s bounds
    at the flagship's width)."""
    cs = _chip_smoke()
    from care_tpu_torch.training import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    opt = dict(cs.flagship_opt("median"), epochs=1, hidden_dropout_prob=0.0,
               encoder_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    assert opt["dim_hidden"] == 768
    loader = cs.SyntheticLoader(opt, 3, 8, 0)
    losses = {}
    for fused in (True, False):
        before = fx.dw_launches
        trainer = Trainer(dict(opt, fused_xent=fused), loader)
        trainer.fit()
        assert trainer._fused_xent is fused
        assert fx.dw_launches - before == (3 if fused else 0)
        losses[fused] = cs._step_losses(trainer)
    assert np.all(np.isfinite(losses[True]))
    np.testing.assert_allclose(losses[True][0], losses[False][0], rtol=1e-5)
    np.testing.assert_allclose(losses[True], losses[False], rtol=0, atol=1e-3)
