"""The beam step's reorder and finished bookkeeping, after the head's top-k.

Two implementations of one step ``t`` of ``decoding/beam_search.py``:

* ``beam_bookkeeping_plain``: the torch ops the beam loop has always run
  (about a hundred small kernels a step at beam 5 on the card); the CPU
  path, and what the tests hold the kernel against;
* the hand-written kernel ``csrc/beam_bookkeeping.cu``, which does it all
  in one launch. It replaces no TPU kernel: XLA fuses the JAX package's
  loop body whole.

``beam_bookkeeping`` takes the kernel for CUDA tensors and the plain
version for CPU tensors; there is no other fallback. Both update the loop
state in place and return the carry's row index, and give the same
values bit for bit: every one is a copy or integer arithmetic.
"""

import ctypes
import functools

import torch

from care_tpu_torch.ops import _build

# kernel launches made by the CUDA path of `beam_bookkeeping`
launches = 0

_STATE = ("tokens", "scores", "last_tokens", "fin_scores", "fin_lengths",
          "fin_tokens", "fin_count")


def beam_bookkeeping_plain(best_scores, best_ids, V: int, t: int,
                           eos_id: int, tokens, scores, last_tokens,
                           fin_scores, fin_lengths, fin_tokens, fin_count):
    """The contract of ``beam_bookkeeping`` in torch ops."""
    N, K, L = tokens.shape
    Fb = fin_scores.shape[1]
    long = dict(dtype=torch.long, device=tokens.device)
    rows = torch.arange(N, device=tokens.device)
    prev_k = torch.div(best_ids, V, rounding_mode="floor")
    new_tok = torch.sub(best_ids, prev_k * V, out=last_tokens)
    # reorder the token history and append the new token at position t
    history = torch.gather(tokens, 1, prev_k[:, :, None].expand(N, K, L))
    history[:, :, t] = new_tok
    row_idx = (rows[:, None] * K + prev_k).reshape(-1)

    is_eos = new_tok == eos_id
    offs = torch.cumsum(is_eos, dim=1) - is_eos.long()
    slot = fin_count[:, None] + offs
    admit = is_eos & (slot < Fb)
    slot_c = slot.clamp(0, Fb - 1)
    zero_col = torch.zeros((N, 1), **long)
    for k in range(K):
        a, sl = admit[:, k], slot_c[:, k]
        fin_scores[rows, sl] = torch.where(
            a, best_scores[:, k], fin_scores[rows, sl])
        fin_lengths[rows, sl] = torch.where(a, t, fin_lengths[rows, sl])
        # generated tokens: positions 1..t of the history (BOS excluded)
        gen = torch.cat([history[:, k, 1:], zero_col], dim=1)
        fin_tokens[rows, sl] = torch.where(a[:, None], gen,
                                           fin_tokens[rows, sl])
    torch.clamp_max(fin_count + admit.sum(dim=1), Fb, out=fin_count)
    tokens.copy_(history)
    scores.copy_(best_scores)
    return row_idx


_ARGTYPES = ([ctypes.c_void_p, ctypes.c_longlong] * 2 + [ctypes.c_int] * 4
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong]
             + [ctypes.c_void_p] * 9)


@functools.cache
def _library():
    lib = _build.load("beam_bookkeeping")
    lib.care_beam_bookkeeping.argtypes = _ARGTYPES
    lib.care_beam_bookkeeping.restype = ctypes.c_int
    lib.care_beam_bookkeeping_max_k.argtypes = []
    lib.care_beam_bookkeeping_max_k.restype = ctypes.c_int
    return lib


def _check(best_scores, best_ids, t: int, state: dict):
    """What the kernel asks of its operands; raises on anything else."""
    tokens = state["tokens"]
    if tokens.dim() != 3:
        raise ValueError(f"tokens {tuple(tokens.shape)} must be [N, K, L]")
    N, K, L = tokens.shape
    Fb = state["fin_scores"].shape[-1]
    shapes = {"best_scores": (N, K), "best_ids": (N, K),
              "scores": (N, K), "last_tokens": (N, K),
              "fin_scores": (N, Fb), "fin_lengths": (N, Fb),
              "fin_tokens": (N, Fb, L), "fin_count": (N,)}
    floats = ("best_scores", "scores", "fin_scores")
    given = dict(state, best_scores=best_scores, best_ids=best_ids)
    for name, x in given.items():
        if name in shapes and tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name} {tuple(x.shape)} must be "
                             f"{shapes[name]}")
        want = torch.float32 if name in floats else torch.long
        if x.dtype != want:
            raise TypeError(f"{name} must be {want}, not {x.dtype}")
        if x.device != tokens.device:
            raise ValueError(f"{name} is on {x.device}, tokens on "
                             f"{tokens.device}")
        # the top-k's rows may sit apart; everything else is contiguous
        if not (x.is_contiguous() if name in state
                else x.stride(1) == 1 or K == 1):
            raise ValueError(f"{name} must be contiguous"
                             + ("" if name in state else " along K"))
    max_k = _library().care_beam_bookkeeping_max_k()
    if not 1 <= K <= min(max_k, Fb):
        raise ValueError(f"beam {K} must lie in [1, {min(max_k, Fb)}]: one "
                         "warp's lanes hold an instance's beams")
    if not 1 <= t < L:
        raise ValueError(f"step {t} outside [1, {L})")


def beam_bookkeeping(best_scores, best_ids, V: int, t: int, eos_id: int,
                     tokens, scores, last_tokens, fin_scores, fin_lengths,
                     fin_tokens, fin_count):
    """Beam step ``t`` after the head's top-k: ``best_scores [N, K]`` f32
    and ``best_ids [N, K]`` int64 over the flat ``k * V + v`` space.

    Updates the loop state in place: ``tokens [N, K, L]`` reordered by
    ``prev_k = best_ids // V`` with the new token at ``t``, ``scores``,
    ``last_tokens [N, K]``; each new EOS row enters the finished buffer
    ``fin_scores / fin_lengths [N, Fb]``, ``fin_tokens [N, Fb, L]`` in beam
    order while ``fin_count [N]`` is below its capacity ``Fb``. Returns
    the carry's row index ``[N * K]``, ``n * K + prev_k``.

    CUDA tensors take the kernel (launched on the current stream, no
    sync; ``K`` up to 32), CPU tensors the plain version."""
    global launches
    state = dict(zip(_STATE, (tokens, scores, last_tokens, fin_scores,
                              fin_lengths, fin_tokens, fin_count)))
    if tokens.device.type == "cpu":
        return beam_bookkeeping_plain(best_scores, best_ids, V, t, eos_id,
                                      **state)
    if tokens.device.type != "cuda":
        raise RuntimeError(f"no beam bookkeeping for device {tokens.device}")
    _check(best_scores, best_ids, t, state)
    N, K, L = tokens.shape
    row_idx = torch.empty((N * K,), dtype=torch.long, device=tokens.device)
    stream = torch.cuda.current_stream(tokens.device).cuda_stream
    rc = _library().care_beam_bookkeeping(
        best_scores.data_ptr(), best_scores.stride(0), best_ids.data_ptr(),
        best_ids.stride(0), N, K, L, fin_scores.shape[1], V, t, eos_id,
        *(x.data_ptr() for x in state.values()), row_idx.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"beam bookkeeping kernel launch failed: CUDA "
                           f"error {rc}")
    launches += 1
    return row_idx
