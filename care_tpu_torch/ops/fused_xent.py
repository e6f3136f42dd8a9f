"""Fused vocab projection + cross-entropy statistics for training.

The port of ``care_tpu/ops/fused_xent.py``. The language criterion needs,
per token position, four statistics of the vocab logits ``h @ W.T + b``:
the log-sum-exp (for the NLL), the label logit, the sum of the logits
(label smoothing's ``mean(-logprobs)`` = ``lse - sum / V``) and the argmax
(the word-accuracy recorder). ``vocab_xent_stats`` gives them without the
``[B, L, V]`` logits, and its backward recomputes the logits tile by tile
and folds the three cotangents

    dlogits = g_lse * softmax + g_label * onehot(label) + g_sum

into ``dh``, ``dW`` and ``db``, so the logits' gradient never exists either.

Forward: ``ops/fused_head_topk.py:argmax_lse_stats`` (the kernel
``csrc/vocab_argmax_lse.cu``). Backward, two implementations:

* ``_bwd_plain``: chunk by chunk over the vocab in plain tensor code, as the
  JAX package's ``lax.scan`` form; the CPU path, and what the ``gpu``
  tests (``tests/test_torch_fused_xent.py``) hold the kernels against;
* ``_bwd_cuda``: the hand-written kernels ``csrc/fused_xent_bwd_dh.cu`` and
  ``csrc/fused_xent_bwd_dw.cu``, which replace the TPU kernels
  ``_bwd_dh_kernel`` and ``_bwd_dw_kernel``.

A CUDA tensor takes the kernels and a CPU tensor the plain versions; there
is no other switch. ``W`` is ``[V, H]`` (the head's ``nn.Linear.weight``),
so ``dW`` is ``[V, H]``, where the JAX package's kernel is ``[H, V]``.

Rounding rules that are part of the function: with bf16 inputs the logits
accumulate in f32, are rounded to bf16, the bias is added in bf16, then
f32; ``dlogits`` is cast to the input dtype before the second products,
which accumulate in f32; ``db`` sums the f32 value of the cast ``dlogits``.
"""

import ctypes
import functools

import torch

from care_tpu_torch.ops import _build
from care_tpu_torch.ops import fused_head_topk as fht

# kernel launches made by the CUDA path of the backward: the dh kernel and
# the dW/db kernel (the forward counts in fused_head_topk.argmax_lse_launches)
dh_launches = 0
dw_launches = 0


def _bwd_plain(h, W, b, labels, lse, gl, gb, gs, chunk_size: int,
               want_dh: bool = True, want_dw: bool = True):
    """(dh [rows, H] in h's dtype, dW [V, H] in W's dtype, db [V] f32);
    a part not asked for is None. All operands flat: h [rows, H], labels,
    lse and the cotangents gl, gb, gs [rows] (f32)."""
    V = W.shape[0]
    chunk_size = fht._clamp_chunk(V, chunk_size)
    dh = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
    dws, dbs = [], []
    for c0 in range(0, V, chunk_size):
        w = W[c0:c0 + chunk_size]
        logits = fht._logits(h, w, None if b is None else b[c0:c0 + chunk_size])
        p = torch.exp(logits - lse[:, None])      # exact softmax recompute
        ids = torch.arange(c0, c0 + w.shape[0], device=h.device)
        dlogits = (gl[:, None] * p
                   + torch.where(ids[None, :] == labels[:, None],
                                 gb[:, None], 0.0)
                   + gs[:, None])
        dlogits = dlogits.to(h.dtype).float()
        if want_dh:
            dh = dh + dlogits @ w.float()
        if want_dw:
            dws.append((dlogits.t() @ h.float()).to(W.dtype))
            dbs.append(dlogits.sum(dim=0))
    return (dh.to(h.dtype) if want_dh else None,
            torch.cat(dws) if want_dw else None,
            torch.cat(dbs) if want_dw else None)


_BWD_ROWS = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3


@functools.cache
def _dh_library():
    lib = _build.load("fused_xent_bwd_dh")
    for fn in (lib.care_xent_bwd_dh_f32, lib.care_xent_bwd_dh_bf16):
        fn.argtypes = _BWD_ROWS + [ctypes.c_void_p] * 2
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _dw_library():
    lib = _build.load("fused_xent_bwd_dw")
    for fn in (lib.care_xent_bwd_dw_f32, lib.care_xent_bwd_dw_bf16):
        fn.argtypes = _BWD_ROWS + [ctypes.c_void_p] * 3
        fn.restype = ctypes.c_int
    return lib


def _bwd_cuda(h, W, b, labels, lse, gl, gb, gs, want_dh: bool = True,
              want_dw: bool = True):
    """The kernels' version of ``_bwd_plain``: one launch of the dh kernel
    and one of the dW/db kernel, each only when asked for, on the current
    stream without syncing."""
    global dh_launches, dw_launches
    fht._check_head_operands(h, W, b)
    rows, H = h.shape
    V = W.shape[0]
    f32 = dict(dtype=torch.float32, device=h.device)
    vectors = []
    for name, t in (("lse", lse), ("g_lse", gl), ("g_label", gb),
                    ("g_sum", gs)):
        if tuple(t.shape) != (rows,) or t.device != h.device:
            raise ValueError(f"{name} {tuple(t.shape)} must be [{rows}] on "
                             f"{h.device}")
        vectors.append(t.to(torch.float32).contiguous())
    if tuple(labels.shape) != (rows,) or labels.device != h.device:
        raise ValueError(f"labels {tuple(labels.shape)} must be [{rows}] on "
                         f"{h.device}")
    labels = labels.to(torch.int32).contiguous()
    head = (h.data_ptr(), W.data_ptr(), None if b is None else b.data_ptr(),
            *(v.data_ptr() for v in vectors), labels.data_ptr(), rows, H, V)
    stream = torch.cuda.current_stream(h.device).cuda_stream
    suffix = "f32" if h.dtype == torch.float32 else "bf16"
    dh = dW = db = None
    if want_dh:
        # dh accumulates on chip: no scratch beyond the output
        dh = torch.empty_like(h)
        rc = getattr(_dh_library(), "care_xent_bwd_dh_" + suffix)(
            *head, dh.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError("fused xent dh kernel launch failed: CUDA "
                               f"error {rc}")
        dh_launches += 1
    if want_dw:
        lib = _dw_library()
        # dW and db accumulate on chip: no scratch beyond the outputs
        dW = torch.empty_like(W)
        db = torch.empty((V,), **f32)
        rc = getattr(lib, "care_xent_bwd_dw_" + suffix)(
            *head, dW.data_ptr(), db.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError("fused xent dW kernel launch failed: CUDA "
                               f"error {rc}")
        dw_launches += 1
    return dh, dW, db


class _VocabXentStats(torch.autograd.Function):

    @staticmethod
    def forward(ctx, h, W, b, labels, chunk_size):
        lead = labels.shape
        hf = h.reshape(-1, h.shape[-1]).contiguous()
        lf = labels.reshape(-1)
        amax, _, lse, lab, tot = fht.argmax_lse_stats(
            hf, W, b, lf, chunk_size, want_sum=True)
        ctx.save_for_backward(hf, W, b, lf, lse)
        ctx.chunk_size = chunk_size
        ctx.h_shape = h.shape
        amax = amax.reshape(lead)
        ctx.mark_non_differentiable(amax)
        return lse.reshape(lead), lab.reshape(lead), tot.reshape(lead), amax

    @staticmethod
    def backward(ctx, g_lse, g_label, g_sum, _g_amax):
        hf, W, b, lf, lse = ctx.saved_tensors
        need_h, need_w, need_b = ctx.needs_input_grad[:3]
        need_w = need_w or (need_b and b is not None)
        gl, gb, gs = (g.reshape(-1).float() for g in (g_lse, g_label, g_sum))
        if hf.device.type == "cuda":
            dh, dW, db = _bwd_cuda(hf, W, b, lf, lse, gl, gb, gs, need_h,
                                   need_w)
        elif hf.device.type == "cpu":
            dh, dW, db = _bwd_plain(hf, W, b, lf, lse, gl, gb, gs,
                                    ctx.chunk_size, need_h, need_w)
        else:
            raise RuntimeError(f"no fused xent path for device {hf.device}")
        return (dh.reshape(ctx.h_shape) if need_h else None,
                dW if ctx.needs_input_grad[1] else None,
                db.to(W.dtype) if need_b and b is not None else None,
                None, None)


def vocab_xent_stats(h, W, b, labels, chunk_size: int = 1024):
    """h: [..., H] hidden states; W: [V, H]; b: [V] or None; labels: [...]
    int. Returns (lse, label_logit, sum_logits, argmax), each shaped like
    ``labels``; differentiable in h, W and b (argmax carries no gradient).
    Equivalent to::

        logits = h @ W.T + b
        (logsumexp(logits, -1), gather(logits, labels), logits.sum(-1),
         logits.argmax(-1))

    ``chunk_size`` sets the vocab chunk of the plain CPU path only; the
    kernels tile the vocab their own way.
    """
    return _VocabXentStats.apply(h, W, b, labels, chunk_size)
