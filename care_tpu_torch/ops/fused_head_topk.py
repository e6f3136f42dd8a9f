"""Fused vocab projection + beam top-k: the [rows, V] logits never live in
device memory as a whole.

The port of ``care_tpu/ops/fused_head_topk.py:fused_head_beam_topk``. Each
beam step's expansion needs, per decoder row, the log-softmax of its logits
only at the few entries that can enter the beam. So the vocab projection
streams into per-row statistics: the max ``m`` and sum of exponentials ``s``
of the logits, and the row's top-``K`` raw logits ``cv`` with their vocab
ids. ``_finalize`` turns those into the beam's top-``K`` over the flat
``k * V + v`` space, exactly as log_softmax + top-k over ``[N, K*V]`` would.

Two implementations of the statistics:

* ``_stats_plain``: chunk by chunk in plain tensor code, as the JAX
  package's ``_stats_xla``; the CPU path, and what the ``gpu`` tests
  (``tests/test_torch_fused_head_topk.py``) hold the kernel against;
* ``_stats_cuda``: the hand-written kernel ``csrc/fused_head_topk.cu``,
  which replaces the TPU kernel ``_fused_kernel``.

``fused_head_beam_topk`` takes the kernel for a CUDA tensor and the plain
version for a CPU tensor; there is no other fallback.

On a mesh's model axis each process holds a block of the vocabulary rows
``[V/tp, H]``: the kernel (or its plain version) streams that block, the
candidate ids move by the block's first row, and the blocks' statistics
merge over the model group (``merge_vocab_shards``): ``m = max_r m_r``,
``s = sum_r s_r exp(m_r - m)`` and the top-K of the tp * K candidates,
lower id first among equal values, as the kernel ranks. The merge is one
all-reduce of the blocks' statistics into zero-filled slots.

``vocab_argmax_lse`` is the second function of the JAX module: per row the
first-occurrence argmax, the max logit and the log-sum-exp of the vocab
logits, optionally the logit at a given token id, again without the
logits. NAR decoding needs it, and with the sum of the logits added it is
the forward of the fused training cross-entropy (``ops/fused_xent.py``). It
has the same two implementations, ``_argmax_lse_plain`` and
``_argmax_lse_cuda`` (``csrc/vocab_argmax_lse.cu``, which replaces the TPU
kernel ``_argmax_lse_kernel``), chosen by the tensor's device alone.

Layouts follow torch: the projection ``W`` is ``[V, H]`` (the
``nn.Linear`` weight of the head), where the JAX package's kernel is
``[H, V]``. Ties between equal values resolve lowest vocab id first in both
implementations, the order ``lax.top_k`` gives.
"""

import ctypes
import functools

import torch
import torch.distributed as dist

from care_tpu_torch.ops import _build
from care_tpu_torch.ops.topk import top_k

DEAD = -1e20
# finite stand-in for -inf on vocab-padding columns of the plain version:
# exp() underflows to exactly 0, and it stays below any real logit
_PAD_LOGIT = -1e30

# kernel launches made by the CUDA path of `fused_head_beam_topk`, so that a
# run can show the main path went through the kernel; `bf16_launches` counts
# those of them that ran the bf16 kernel
launches = 0
bf16_launches = 0
# the same for the CUDA path of `vocab_argmax_lse` / `argmax_lse_stats`
argmax_lse_launches = 0


def _clamp_chunk(V: int, chunk_size: int) -> int:
    """Never use a chunk wider than the (128-aligned) vocab itself."""
    return min(chunk_size, max(128, -(-V // 128) * 128))


def _logits(h, W, bias):
    """h [rows, H] @ W [n, H]^T (+ bias [n]) as f32, rounded like the JAX
    package's kernel: the product accumulates in f32; with bf16 inputs it is
    rounded to bf16 and the bias added in bf16."""
    x = h.float() @ W.float().t()
    if h.dtype != torch.float32:
        x = x.to(h.dtype)
    if bias is not None:
        x = x + bias
    return x.float()


def _stats_plain(h, W, b, beam_k: int, chunk_size: int):
    """Returns (cv [rows, K] f32, ids [rows, K] int64, m [rows] f32,
    s [rows] f32), chunk by chunk over the vocab like ``_stats_xla``."""
    rows = h.shape[0]
    V = W.shape[0]
    chunk_size = _clamp_chunk(V, chunk_size)
    m = torch.full((rows,), float("-inf"), device=h.device)
    s = torch.zeros((rows,), device=h.device)
    cand_v, cand_i = [], []
    for c0 in range(0, V, chunk_size):
        w = W[c0:c0 + chunk_size]
        pad = chunk_size - w.shape[0]
        bias = None if b is None else b[c0:c0 + chunk_size]
        if pad:
            w = torch.cat([w, w.new_zeros(pad, w.shape[1])])
            if bias is None:
                bias = torch.zeros(V - c0, dtype=h.dtype, device=h.device)
            bias = torch.cat([bias, bias.new_full((pad,), _PAD_LOGIT)])
        logits = _logits(h, w, bias)
        m_new = torch.maximum(m, logits.max(dim=-1).values)
        s = (s * torch.exp(m - m_new)
             + torch.exp(logits - m_new[:, None]).sum(dim=-1))
        m = m_new
        vals, args = top_k(logits, beam_k)
        cand_v.append(vals)
        cand_i.append(args + c0)
    # candidates sit in (chunk, rank) order, so among equal values the
    # lower position holds the lower vocab id
    cv, sel = top_k(torch.cat(cand_v, dim=1), beam_k)
    ids = torch.gather(torch.cat(cand_i, dim=1), 1, sel)
    return cv, ids, m, s


_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 9


@functools.cache
def _library():
    lib = _build.load("fused_head_topk")
    for fn in (lib.care_fused_head_topk_f32, lib.care_fused_head_topk_bf16):
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    for fn in (lib.care_fused_head_topk_tile_cols,
               lib.care_fused_head_topk_max_k):
        fn.argtypes = []
        fn.restype = ctypes.c_int
    return lib


def _stats_cuda(h, W, b, beam_k: int):
    """The kernel's (cv, ids, m, s), ids int32; the same contract as
    ``_stats_plain``. Launches on the current stream without syncing."""
    global launches, bf16_launches
    _check_head_operands(h, W, b)
    rows, H = h.shape
    V = W.shape[0]
    lib = _library()
    max_k = min(V, lib.care_fused_head_topk_max_k())
    if not 1 <= beam_k <= max_k:
        raise ValueError(f"beam_k {beam_k} must lie in [1, {max_k}]: the "
                         "kernel keeps each row's top-K in registers")
    n_tiles = -(-V // lib.care_fused_head_topk_tile_cols())
    f32 = dict(dtype=torch.float32, device=h.device)
    i32 = dict(dtype=torch.int32, device=h.device)
    part_m = torch.empty((rows, n_tiles), **f32)
    part_s = torch.empty((rows, n_tiles), **f32)
    part_v = torch.empty((rows, n_tiles, beam_k), **f32)
    part_i = torch.empty((rows, n_tiles, beam_k), **i32)
    m = torch.empty((rows,), **f32)
    s = torch.empty((rows,), **f32)
    cv = torch.empty((rows, beam_k), **f32)
    ids = torch.empty((rows, beam_k), **i32)
    fn = (lib.care_fused_head_topk_f32 if h.dtype == torch.float32
          else lib.care_fused_head_topk_bf16)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = fn(h.data_ptr(), W.data_ptr(), None if b is None else b.data_ptr(),
            rows, H, V, beam_k, part_m.data_ptr(), part_s.data_ptr(),
            part_v.data_ptr(), part_i.data_ptr(), m.data_ptr(), s.data_ptr(),
            cv.data_ptr(), ids.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"fused head kernel launch failed: CUDA error {rc}")
    launches += 1
    bf16_launches += int(h.dtype == torch.bfloat16)
    return cv, ids, m, s


def _check_head_operands(h, W, b):
    """What both kernels ask of (h [rows, H], W [V, H], b [V] or None)."""
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fused head kernel takes f32 or bf16, not {h.dtype}")
    if W.dtype != h.dtype or (b is not None and b.dtype != h.dtype):
        raise TypeError("h, W and b must share one dtype")
    if h.dim() != 2 or W.dim() != 2 or h.shape[1] != W.shape[1]:
        raise ValueError(f"h {tuple(h.shape)} and W {tuple(W.shape)} "
                         "must be [rows, H] and [V, H]")
    if b is not None and tuple(b.shape) != (W.shape[0],):
        raise ValueError(f"bias {tuple(b.shape)} must be [{W.shape[0]}]")
    for name, t in (("h", h), ("W", W), ("b", b)):
        if t is not None and (t.device != h.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{h.device}")


def _finalize(cv, ids, m, s, scores, eos_row, beam_k: int, V: int):
    """(per-row raw-logit candidates, softmax stats) -> the beam's top-k.
    cv/ids: [rows, n_cand] with ties in lowest-id-first order."""
    N, Kb = scores.shape
    n_cand = cv.shape[1]
    # log_softmax association: (x - max) - log(sumexp), then the DEAD
    # clamp, then the beam-score add, op for op as the unfused path
    logp = (cv - m[:, None]) - torch.log(s)[:, None]
    logp = torch.clamp_min(logp, DEAD)
    lk = scores[:, :, None] + logp.reshape(N, Kb, n_cand)
    lk = lk.masked_fill(eos_row[:, :, None], DEAD)
    flat_val = lk.reshape(N, Kb * n_cand)
    flat_idx = (torch.arange(Kb, device=ids.device)[None, :, None] * V
                + ids.reshape(N, Kb, n_cand).long()).reshape(N, Kb * n_cand)
    best, sel = top_k(flat_val, beam_k)
    return best, torch.gather(flat_idx, 1, sel)


def merge_vocab_shards(cv, ids, m, s, beam_k: int):
    """The statistics of the whole vocabulary from those of its blocks:
    cv, ids [rows, R, K] (ids already global), m, s [rows, R]. Returns
    (cv, ids [rows, K], m, s [rows]). Blocks sit in vocab order and each
    holds its candidates lower id first among ties, so the stable top-k
    over the flattened candidates gives the lower id on a tie."""
    rows, R, K = cv.shape
    m_all = m.max(dim=1).values
    s_all = (s * torch.exp(m - m_all[:, None])).sum(dim=1)
    best, sel = top_k(cv.reshape(rows, R * K), beam_k)
    return best, torch.gather(ids.reshape(rows, R * K), 1, sel), m_all, s_all


def _merge_over_model(cv, ids, m, s, beam_k: int, ax):
    """``merge_vocab_shards`` of every process's block on the model axis
    ``ax``: one all-reduce of [cv | ids | m | s] into this process's slot
    (ids are exact in f32 below 2**24)."""
    rows, K = cv.shape
    slots = cv.new_zeros((rows, ax.size, 2 * K + 2))
    mine = slots[:, ax.rank]
    mine[:, :K] = cv
    mine[:, K:2 * K] = ids.float()
    mine[:, 2 * K] = m
    mine[:, 2 * K + 1] = s
    dist.all_reduce(slots, group=ax.group())
    return merge_vocab_shards(slots[:, :, :K], slots[:, :, K:2 * K].long(),
                              slots[:, :, 2 * K], slots[:, :, 2 * K + 1],
                              beam_k)


def fused_head_beam_topk(h, W, b, scores, eos_row, beam_k: int,
                         chunk_size: int = 1024, vocab_axis=None):
    """h: [N*K, H] decoder hidden states; W: [V, H] vocab projection; b: [V]
    or None; scores: [N, K] f32 cumulative beam scores; eos_row: [N, K] bool,
    rows already finished. Returns (best_scores [N, K], best_ids [N, K]
    int64) over the flat k*V + v space, as

        logp = log_softmax((h @ W.T + b).float())
        lk   = scores[:, :, None] + maximum(logp, DEAD).reshape(N, K, V)
        lk   = where(eos_row[:, :, None], DEAD, lk)
        top_k(lk.reshape(N, K * V), K)

    would give. ``chunk_size`` sets the vocab chunk of the plain CPU path
    only; the kernel tiles the vocab its own way. Both give the same ids.

    Mixed operands compute in their promoted dtype, as the unfused linear
    head would: bf16 h against an f32 W (the ``decode_head_f32`` serving
    flag) runs in f32 with no rounding of the logits; only an all-bf16
    product rounds them to bf16 before the bias. The kernel itself takes
    one dtype.

    ``vocab_axis`` (a mesh ``Axis`` of more than one process): ``W`` is
    this process's block of the vocabulary rows and ``b`` the whole bias
    (or the block's); the result is that of the whole vocabulary.
    """
    if h.dtype != W.dtype or (b is not None and b.dtype != W.dtype):
        dtype = torch.promote_types(h.dtype, W.dtype)
        if b is not None:
            dtype = torch.promote_types(dtype, b.dtype)
        h, W = h.to(dtype), W.to(dtype)
        b = None if b is None else b.to(dtype)
    rows = h.shape[0]
    V = W.shape[0]
    N, Kb = scores.shape
    if rows != N * Kb:
        raise ValueError(f"h has {rows} rows for {N} x {Kb} beams")
    sharded = vocab_axis is not None and vocab_axis.size > 1
    row0 = vocab_axis.rank * V if sharded else 0
    if sharded and b is not None and b.shape[0] != V:
        b = b[row0:row0 + V].contiguous()
    if h.device.type == "cuda":
        cv, ids, m, s = _stats_cuda(h, W, b, beam_k)
    elif h.device.type == "cpu":
        cv, ids, m, s = _stats_plain(h, W, b, beam_k, chunk_size)
    else:
        raise RuntimeError(f"no fused head path for device {h.device}")
    if sharded:
        cv, ids, m, s = _merge_over_model(cv, ids.long() + row0, m, s,
                                          beam_k, vocab_axis)
        V *= vocab_axis.size
    return _finalize(cv, ids, m, s, scores, eos_row, beam_k, V)


# ---------------------------------------------------------------------------
# argmax / max / lse (/ token logit / sum) of the vocab logits
# ---------------------------------------------------------------------------

def _argmax_lse_plain(h, W, b, tokens, chunk_size: int, want_sum: bool):
    """(argmax [rows] int64, max, lse, token logit or None, sum or None),
    f32, chunk by chunk over the vocab like the ``lax.scan`` form of the JAX
    package. ``tokens`` [rows] int or None."""
    rows = h.shape[0]
    V = W.shape[0]
    chunk_size = _clamp_chunk(V, chunk_size)
    dev = h.device
    m = torch.full((rows,), float("-inf"), device=dev)
    s = torch.zeros((rows,), device=dev)
    av = torch.full((rows,), float("-inf"), device=dev)
    ai = torch.zeros((rows,), dtype=torch.long, device=dev)
    tok = None if tokens is None else torch.zeros((rows,), device=dev)
    tot = torch.zeros((rows,), device=dev) if want_sum else None
    for c0 in range(0, V, chunk_size):
        logits = _logits(h, W[c0:c0 + chunk_size],
                         None if b is None else b[c0:c0 + chunk_size])
        # torch.max returns the first of equal maxima
        mc, ci = logits.max(dim=-1)
        m_new = torch.maximum(m, mc)
        s = (s * torch.exp(m - m_new)
             + torch.exp(logits - m_new[:, None]).sum(dim=-1))
        m = m_new
        better = mc > av                  # strict: the lower chunk keeps ties
        av = torch.where(better, mc, av)
        ai = torch.where(better, ci + c0, ai)
        if tokens is not None:
            ids = torch.arange(c0, c0 + logits.shape[1], device=dev)
            tok = tok + torch.where(ids[None, :] == tokens[:, None], logits,
                                    0.0).sum(dim=-1)
        if want_sum:
            tot = tot + logits.sum(dim=-1)
    return ai, av, m + torch.log(s), tok, tot


_ARGMAX_LSE_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                        + [ctypes.c_void_p] * 10)


@functools.cache
def _argmax_lse_library():
    lib = _build.load("vocab_argmax_lse")
    for fn in (lib.care_vocab_argmax_lse_f32, lib.care_vocab_argmax_lse_bf16):
        fn.argtypes = _ARGMAX_LSE_ARGTYPES
        fn.restype = ctypes.c_int
    lib.care_vocab_argmax_lse_parts.argtypes = [ctypes.c_int] * 2
    lib.care_vocab_argmax_lse_parts.restype = ctypes.c_int
    return lib


def _argmax_lse_cuda(h, W, b, tokens, want_sum: bool):
    """The kernel's version of ``_argmax_lse_plain`` (argmax int32).
    Launches on the current stream without syncing."""
    global argmax_lse_launches
    _check_head_operands(h, W, b)
    rows, H = h.shape
    V = W.shape[0]
    if tokens is not None:
        if tuple(tokens.shape) != (rows,) or tokens.device != h.device:
            raise ValueError(f"token ids {tuple(tokens.shape)} must be "
                             f"[{rows}] on {h.device}")
        tokens = tokens.to(torch.int32).contiguous()
    lib = _argmax_lse_library()
    # one partial per row and vocab split; the kernel picks the splits for
    # the card it runs on
    n_parts = lib.care_vocab_argmax_lse_parts(rows, V)
    f32 = dict(dtype=torch.float32, device=h.device)
    i32 = dict(dtype=torch.int32, device=h.device)
    part_m = torch.empty((rows, n_parts), **f32)
    part_s = torch.empty((rows, n_parts), **f32)
    part_i = torch.empty((rows, n_parts), **i32)
    part_t = torch.empty((rows, n_parts), **f32) if want_sum else None
    amax = torch.empty((rows,), **i32)
    mx = torch.empty((rows,), **f32)
    lse = torch.empty((rows,), **f32)
    # the one tile that holds a row's token writes it; ids outside the
    # vocab leave the zero
    tok = None if tokens is None else torch.zeros((rows,), **f32)
    tot = torch.empty((rows,), **f32) if want_sum else None
    ptr = lambda t: None if t is None else t.data_ptr()
    fn = (lib.care_vocab_argmax_lse_f32 if h.dtype == torch.float32
          else lib.care_vocab_argmax_lse_bf16)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    rc = fn(h.data_ptr(), W.data_ptr(), ptr(b), ptr(tokens), rows, H, V,
            int(want_sum), part_m.data_ptr(), part_s.data_ptr(),
            part_i.data_ptr(), ptr(part_t), amax.data_ptr(), mx.data_ptr(),
            lse.data_ptr(), ptr(tok), ptr(tot), stream)
    if rc != 0:
        raise RuntimeError("vocab argmax/lse kernel launch failed: CUDA "
                           f"error {rc}")
    argmax_lse_launches += 1
    return amax, mx, lse, tok, tot


def argmax_lse_stats(h, W, b, tokens, chunk_size: int = 1024,
                     want_sum: bool = False):
    """h [rows, H], W [V, H], b [V] or None, tokens [rows] int or None ->
    (argmax [rows] int64, max logit, lse, token logit or None, sum of
    logits or None), the statistics in f32. A CUDA tensor takes the kernel,
    a CPU tensor the plain version (the only use of ``chunk_size``)."""
    if h.device.type == "cuda":
        out = _argmax_lse_cuda(h, W, b, tokens, want_sum)
    elif h.device.type == "cpu":
        out = _argmax_lse_plain(h, W, b, tokens, chunk_size, want_sum)
    else:
        raise RuntimeError(f"no fused head path for device {h.device}")
    return (out[0].long(),) + tuple(out[1:])


@torch.no_grad()
def vocab_argmax_lse(h, W, b, token_ids=None, chunk_size: int = 1024):
    """(argmax, max logit, logsumexp[, token logit]) of ``h @ W.T + b`` over
    the vocab axis, without the ``[..., V]`` logits: what the NAR decode
    loop needs (the argmax token and its probability ``exp(max - lse)``;
    teacher rescoring's ``exp(tok - lse)``). Serving only, no gradient.

    h: [..., H]; W: [V, H]; b: [V] or None; token_ids: [...] int or None.
    Each output is shaped like ``h.shape[:-1]``; argmax is int64 and ties
    go to the lowest id, as ``argmax`` over the full row would give. Mixed
    operands (bf16 hidden states on the f32 head of ``decode_head_f32``)
    compute in their promoted dtype, as the JAX package's do.
    """
    if h.dtype != W.dtype or (b is not None and b.dtype != W.dtype):
        dtype = torch.promote_types(h.dtype, W.dtype)
        if b is not None:
            dtype = torch.promote_types(dtype, b.dtype)
        h, W = h.to(dtype), W.to(dtype)
        b = None if b is None else b.to(dtype)
    lead = h.shape[:-1]
    hf = h.reshape(-1, h.shape[-1]).contiguous()
    tf = None if token_ids is None else token_ids.reshape(-1)
    ai, av, lse, tok, _ = argmax_lse_stats(hf, W, b, tf, chunk_size)
    out = (ai.reshape(lead), av.reshape(lead), lse.reshape(lead))
    if token_ids is not None:
        out = out + (tok.reshape(lead),)
    return out
