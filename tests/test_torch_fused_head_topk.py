"""The port's fused vocab projection + beam top-k
(``care_tpu_torch/ops/fused_head_topk.py``) against the JAX package's
``fused_head_beam_topk``, run as the JAX suite runs it on the CPU: the
Pallas kernel in interpret mode, and the ``xla`` backend. On the CPU the
port takes its plain version (``_stats_plain`` + ``_finalize``); the CUDA
kernel is held against that plain version by the ``gpu`` test below,
through ``torch_card_cases``'s check.

The cases are those of ``tests/test_fused_head_topk.py``. Ids must be
identical; values agree within 1e-6 (both sides compute in f32, and only
the order of the f32 sums inside the products and the softmax differs).
"""

import numpy as np
import pytest
import torch
import torch_card_cases as cc

from care_tpu_torch.ops import fused_head_topk as port_fht

BACKENDS = ["pallas", "xla"]
DEAD = port_fht.DEAD


def _jax(h, W, b, scores, eos_row, K, chunk, backend, dtype="float32"):
    # imported here: the gpu tests below need neither JAX nor the JAX
    # package, which does not import on the machine with the card
    import jax.numpy as jnp
    from care_tpu.ops import fused_head_topk as jax_fht
    dtype = jnp.dtype(dtype)
    v, i = jax_fht.fused_head_beam_topk(
        jnp.asarray(h, dtype), jnp.asarray(W, dtype),
        None if b is None else jnp.asarray(b, dtype),
        jnp.asarray(scores), jnp.asarray(eos_row), K, chunk_size=chunk,
        backend=backend, block_rows=8, interpret=backend == "pallas")
    return np.asarray(v), np.asarray(i)


def _port(h, W, b, scores, eos_row, K, chunk, dtype=torch.float32):
    v, i = port_fht.fused_head_beam_topk(
        torch.as_tensor(h, dtype=dtype),
        torch.as_tensor(np.ascontiguousarray(W.T), dtype=dtype),
        None if b is None else torch.as_tensor(b, dtype=dtype),
        torch.as_tensor(scores), torch.as_tensor(eos_row), K,
        chunk_size=chunk)
    return v.numpy(), i.numpy()


def _case(name):
    """(h [N*K, H], W [H, V] (the JAX layout), b, scores, eos_row, K, chunk)."""
    rng = np.random.RandomState(0)
    if name == "ties":
        # W columns engineered so many logits collide exactly, within and
        # across chunks (tests/test_fused_head_topk.py tie case)
        N, Kb, H, V = 1, 2, 8, 260
        rng = np.random.RandomState(3)
        h = np.ones((N * Kb, H), np.float32)
        cols = rng.randint(0, 5, size=(V,)).astype(np.float32) / 8.0
        W = (np.tile(cols[None, :], (H, 1)) / H).astype(np.float32)
        return (h, W, None, np.zeros((N, Kb), np.float32),
                np.zeros((N, Kb), bool), Kb, 128)
    if name == "duplicated_columns":
        # every column repeats 37 columns later, across chunk borders
        N, Kb, H, V = 2, 3, 16, 700
        h = rng.randn(N * Kb, H).astype(np.float32)
        W = (rng.randn(H, 37) * 0.1).astype(np.float32)[:, np.arange(V) % 37]
        return (h, W, None, rng.randn(N, Kb).astype(np.float32),
                np.zeros((N, Kb), bool), Kb, 128)
    if name == "all_eos":
        N, Kb, H, V = 2, 3, 16, 500
        rng = np.random.RandomState(1)
        return (rng.randn(N * Kb, H).astype(np.float32),
                (rng.randn(H, V) * 0.1).astype(np.float32), None,
                rng.randn(N, Kb).astype(np.float32),
                np.ones((N, Kb), bool), Kb, 128)
    if name == "ragged_rows":
        # 3 x 5 = 15 rows: not a multiple of the kernel's 8-row blocks
        N, Kb, H, V = 3, 5, 24, 333
        eos = np.zeros((N, Kb), bool)
        eos[2, 1] = True
        return (rng.randn(N * Kb, H).astype(np.float32),
                (rng.randn(H, V) * 0.2).astype(np.float32), None,
                rng.randn(N, Kb).astype(np.float32), eos, Kb, 128)
    # "V<V>_chunk<c>[_bias]": V not (or) a multiple of the chunk, +/- bias
    parts = name.split("_")
    V, chunk = int(parts[0][1:]), int(parts[1][5:])
    N, Kb, H = 3, 4, 32
    h = rng.randn(N * Kb, H).astype(np.float32)
    W = (rng.randn(H, V) * 0.1).astype(np.float32)
    b = (rng.randn(V) * 0.1).astype(np.float32) if "bias" in parts else None
    scores = rng.randn(N, Kb).astype(np.float32)
    scores[:, 2] = DEAD                 # a dead-score beam row
    eos = np.zeros((N, Kb), bool)
    eos[1, 0] = True
    return h, W, b, scores, eos, Kb, chunk


CASES = ["V300_chunk128", "V1000_chunk256", "V1031_chunk256",
         "V1031_chunk256_bias", "V300_chunk128_bias", "ties",
         "duplicated_columns", "ragged_rows", "all_eos"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(case, backend):
    h, W, b, scores, eos, K, chunk = _case(case)
    want_v, want_i = _jax(h, W, b, scores, eos, K, chunk, backend)
    got_v, got_i = _port(h, W, b, scores, eos, K, chunk)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    if case == "all_eos" and backend == "xla":
        # every candidate ties at DEAD; the xla backend keeps C*K
        # candidates per row where the kernel (and the port) keep K, so
        # the lowest-position picks name other ids: only values compare
        # (the beam never admits such picks as hypotheses)
        assert np.all(got_v == DEAD)
        return
    np.testing.assert_array_equal(got_i, want_i)


@pytest.mark.parametrize("backend", BACKENDS)
def test_bf16_inputs_checked_on_values(backend):
    """bf16 h/W and bias. The port rounds the f32 product to bf16, adds the
    bias in bf16 and goes to f32 for the softmax, as ``_stats_pallas``
    states; XLA on the CPU keeps excess precision and drops those bf16
    round trips. Inputs are drawn so that every logit, before and after
    the bias, is exact in bf16: then both readings give the same values,
    and the many exact ties check the tie order too."""
    rng = np.random.RandomState(2)
    N, Kb, H, V = 2, 3, 32, 700
    h = (rng.randint(-1, 2, (N * Kb, H)) / 2).astype(np.float32)
    W = (rng.randint(-1, 2, (H, V)) / 4).astype(np.float32)
    b = (rng.randint(-2, 3, (V,)) / 8).astype(np.float32)
    scores = rng.randn(N, Kb).astype(np.float32)
    eos = np.zeros((N, Kb), bool)
    want_v, want_i = _jax(h, W, b, scores, eos, Kb, 256, backend,
                          "bfloat16")
    got_v, got_i = _port(h, W, b, scores, eos, Kb, 256, torch.bfloat16)
    np.testing.assert_allclose(got_v, want_v, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got_i, want_i)


def test_cpu_call_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(port_fht, "launches", 0)
    h, W, b, scores, eos, K, chunk = _case("V300_chunk128")
    _port(h, W, b, scores, eos, K, chunk)
    assert port_fht.launches == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("rows,V,K,ties", [
    (320, 11000, 5, True),      # the flagship's shape, columns repeating
    (320, 11000, 5, False),     # the flagship's shape
    (320, 10997, 5, False),     # the serve shape; V a multiple of no tile
    (85, 10997, 5, False),      # a ragged batch (17 videos x beam 5)
    (85, 10997, 16, True),      # beams above 8: the kernel's 32-long lists
])
def test_kernel_matches_plain(cuda_device, rows, V, K, ties, with_bias,
                              dtype):
    """The CUDA kernel against the plain version, H 512, through
    ``torch_card_cases.check_head_case``: m and log s within 1e-5 relative
    + 1e-6, cv within 1e-4, and ids equal wherever values are exact (dyadic
    operands: bf16, and the ``ties`` cases, where every column repeats 37
    later) or else separated from their neighbours by more than 1e-4."""
    exact = ties or dtype == torch.bfloat16
    h, W, b, _, _ = cc.xent_inputs(rows, 512, V, dtype, exact, with_bias,
                                   rows + K)
    if ties:
        W = cc.tie(W)
    before = port_fht.launches
    cc.check_head_case(f"rows {rows} V {V} K {K}", h, W, K, exact, b)
    assert port_fht.launches == before + 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_argmax_lse_plain_matches_jax_at_a_nar_shape(backend):
    """The argmax/lse function's plain version where NAR decoding calls it:
    the hidden states of a length beam [N, lbs, max_len, H] (ragged
    lengths: PAD rows beside words), with the token ids of teacher
    rescoring, against the JAX package's ``vocab_argmax_lse`` (the Pallas
    kernel in interpret mode, and ``xla``): argmax and the exp(max - lse)
    / exp(token - lse) probabilities the decode keeps."""
    import jax.numpy as jnp
    from care_tpu.ops.fused_head_topk import vocab_argmax_lse as jax_fn

    rng = np.random.RandomState(9)
    N, lbs, L, H, V = 2, 3, 10, 32, 1031
    h = rng.randn(N, lbs, L, H).astype(np.float32)
    h[:, :, 7:] = h[:, :, 6:7]                 # identical PAD rows
    W = (rng.randn(H, V) * 0.3).astype(np.float32)
    tokens = rng.randint(0, V, (N, lbs, L)).astype(np.int32)
    want = jax_fn(jnp.asarray(h), jnp.asarray(W), None, jnp.asarray(tokens),
                  chunk_size=256, backend=backend, block_rows=8,
                  interpret=backend == "pallas")
    got = port_fht.vocab_argmax_lse(
        torch.as_tensor(h), torch.as_tensor(np.ascontiguousarray(W.T)), None,
        torch.as_tensor(tokens).long(), chunk_size=256)
    assert [tuple(g.shape) for g in got] == [(N, lbs, L)] * 4
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for i in (1, 2, 3):
        np.testing.assert_allclose(got[i].numpy(), np.asarray(want[i]),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(torch.exp(got[1] - got[2]).numpy(),
                               np.exp(np.asarray(want[1] - want[2])),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(torch.exp(got[3] - got[2]).numpy(),
                               np.exp(np.asarray(want[3] - want[2])),
                               rtol=0, atol=1e-6)
