"""Flash attention: softmax attention by key tiles with an online softmax,
so that the ``[Lq, Lk]`` scores and probabilities never live in device
memory.

The port of ``care_tpu/ops/pallas/flash_attention.py``. The model takes it
for the cross attention of the KV-cached decode step once the key axis is
long (``feats: SwinBERTDense`` reaches 1654 keys); ``flash_attention`` is
also differentiable on its own, through ``_Flash``, a
``torch.autograd.Function`` in the place of the JAX package's
``custom_vjp``.

Per function two implementations, chosen by the tensors' device alone:

* forward: ``_flash_fwd_cuda`` launches ``csrc/flash_attention_fwd.cu``
  (which replaces the TPU kernel ``_flash_fwd_kernel``); ``_flash_fwd_plain``
  is the same recurrence in plain tensor code;
* backward: ``_flash_bwd_cuda`` launches ``csrc/flash_attention_bwd_dq.cu``
  and ``csrc/flash_attention_bwd_dkv.cu`` (``_flash_bwd_dq_kernel``,
  ``_flash_bwd_dkv_kernel``); ``_flash_bwd_plain`` repeats them.

A CUDA tensor launches the kernels or raises; a CPU tensor takes the plain
versions, which also serve the tests and ``chip_smoke.py`` as what the
kernels are held against.

What is part of the function: scores accumulate in f32, are scaled by
``Dh ** -0.5`` and take the f32 bias; the running maximum starts at -1e9,
not -inf, so a row whose keys all carry the -1e9 mask gets the dense
softmax's nearly uniform weights; the weights are rounded to the input type
before ``p @ v`` while their sum is taken unrounded; a row whose sum is 0
gives output 0 and lse 1e9. In the backward ``p = exp(s - lse)``,
``g = p * (do @ v.T - delta)``, ``dq = (g @ k) * scale``,
``dk = (g.T @ q) * scale``, ``dv = p.T @ do``, ``dbias = sum over rows of
g``, with ``p`` and ``g`` rounded to the input type before their products.

Unlike the TPU version nothing is padded or broadcast in memory: the
kernels read the bias through its own strides (0 on an axis it broadcasts
over) and mask the ragged edges by bounds checks, and they choose their own
tiles.
"""

import ctypes
import functools
import math

import torch

from care_tpu_torch.ops import _build

NEG_INF = -1e9

# memory rule of the ``auto`` backward: the dense rule keeps the
# [B, H, Lq, Lk] f32 probabilities between its forward and backward; above
# this many bytes of them the kernels take over, which store nothing of
# that size
_BWD_KERNEL_MIN_BYTES = 2e9

# kernel launches made by the CUDA paths, so that a run can show that it went
# through the kernels (`fwd_bf16_launches`: the forwards that ran in bf16);
# `plain_forward_calls` counts the CPU path's forwards
fwd_launches = 0
fwd_bf16_launches = 0
dq_launches = 0
dkv_launches = 0
plain_forward_calls = 0

_HEAD_WIDTHS = (32, 64, 128)
_PLAIN_BLOCK = 64


def _expanded_bias(bias, b, h, lq, lk):
    """The bias as an f32 view of shape [b, h, lq, lk], stride 0 on every
    axis it broadcasts over; nothing of that size is made."""
    return bias.to(torch.float32).expand(b, h, lq, lk)


def _attention_reference(q, k, v, bias):
    """Plain attention, softmax in f32: what the dense backward rule
    differentiates (recompute instead of stored probabilities)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.matmul(q, k.transpose(-1, -2)).float() * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.matmul(p, v)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _flash_fwd_plain(q, k, v, bias, block_q: int = _PLAIN_BLOCK,
                     block_k: int = _PLAIN_BLOCK, key_splits: int = 1):
    """(out [B, H, Lq, Dh] in q's dtype, lse [B, H, Lq] f32): the forward
    kernel's arithmetic, query block by query block and key block by key
    block, a ragged last block being simply shorter.

    ``key_splits`` > 1 repeats the kernel's split of the keys over a cluster
    of blocks: the key blocks fall into that many consecutive runs of
    ceil(blocks / key_splits) (the last runs may hold no key at all), each
    run keeps its own (maximum, sum, accumulator) from -1e9, 0, 0, and the
    runs are merged in order, each weighted by exp(its maximum - the
    largest); a row whose merged sum is 0 gives output 0 and lse 1e9."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    bias = None if bias is None else _expanded_bias(bias, b, h, lq, lk)
    f32 = dict(dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), **f32)
    starts = list(range(0, lk, block_k))
    per = -(-len(starts) // key_splits)
    for q0 in range(0, lq, block_q):
        qs = slice(q0, q0 + block_q)
        qb = q[:, :, qs].float()
        rows = qb.shape[2]
        runs = []
        for c in range(key_splits):
            m = torch.full((b, h, rows, 1), NEG_INF, **f32)
            l = torch.zeros((b, h, rows, 1), **f32)
            acc = torch.zeros((b, h, rows, dh), **f32)
            for k0 in starts[c * per:(c + 1) * per]:
                ks = slice(k0, k0 + block_k)
                s = torch.matmul(qb, k[:, :, ks].float().transpose(-1, -2)) \
                    * scale
                if bias is not None:
                    s = s + bias[:, :, qs, ks]
                m_new = torch.maximum(m, s.max(dim=-1, keepdim=True).values)
                p = torch.exp(s - m_new)
                alpha = torch.exp(m - m_new)
                l = alpha * l + p.sum(dim=-1, keepdim=True)
                acc = acc * alpha + torch.matmul(p.to(v.dtype).float(),
                                                 v[:, :, ks].float())
                m = m_new
            runs.append((m, l, acc))
        m = runs[0][0]
        for run in runs[1:]:
            m = torch.maximum(m, run[0])
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, rows, dh), **f32)
        for m_c, l_c, acc_c in runs:
            w = torch.exp(m_c - m)
            l = l + l_c * w
            acc = acc + acc_c * w
        empty = l == 0.0
        safe = torch.where(empty, torch.ones_like(l), l)
        out[:, :, qs] = (acc / safe).to(q.dtype)
        lse[:, :, qs] = torch.where(empty, torch.full_like(l, 1e9),
                                    m + torch.log(safe))[..., 0]
    return out, lse


def _flash_bwd_plain(q, k, v, bias, lse, do, delta,
                     block_q: int = _PLAIN_BLOCK, block_k: int = _PLAIN_BLOCK):
    """(dq, dk, dv in the inputs' dtype, dbias [B, H, 1, Lk] f32 or None):
    the two backward kernels' arithmetic, block by block. ``bias`` has no
    query extent; ``lse`` and ``delta`` are [B, H, Lq] f32."""
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    scale = 1.0 / math.sqrt(dh)
    if bias is not None:
        bias = _expanded_bias(bias, b, h, 1, lk)
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.zeros(q.shape, **f32)
    dk = torch.zeros(k.shape, **f32)
    dv = torch.zeros(v.shape, **f32)
    dbias = None if bias is None else torch.zeros((b, h, 1, lk), **f32)
    for q0 in range(0, lq, block_q):
        qs = slice(q0, q0 + block_q)
        qb, dob = q[:, :, qs].float(), do[:, :, qs].float()
        row_lse, row_delta = lse[:, :, qs, None], delta[:, :, qs, None]
        for k0 in range(0, lk, block_k):
            ks = slice(k0, k0 + block_k)
            kb, vb = k[:, :, ks].float(), v[:, :, ks].float()
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            if bias is not None:
                s = s + bias[:, :, :, ks]
            p = torch.exp(s - row_lse)
            dp = torch.matmul(dob, vb.transpose(-1, -2))
            g = p * (dp - row_delta)
            g_in = g.to(q.dtype).float()
            dq[:, :, qs] += torch.matmul(g_in, kb) * scale
            dk[:, :, ks] += torch.matmul(g_in.transpose(-1, -2), qb) * scale
            dv[:, :, ks] += torch.matmul(
                p.to(do.dtype).float().transpose(-1, -2), dob)
            if dbias is not None:
                dbias[:, :, :, ks] += g.sum(dim=2, keepdim=True)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---------------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------------

_PTR, _INT, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_SHAPE = [_INT] * 5                          # B, H, Lq, Lk, Dh


def _bind(lib, stem, argtypes):
    for suffix in ("f32", "bf16"):
        fn = getattr(lib, f"{stem}_{suffix}")
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _fwd_library():
    # q, k, v, bias, 4 bias strides, shape, out, lse, stream
    lib = _bind(_build.load("flash_attention_fwd"), "care_flash_fwd",
                [_PTR] * 4 + [_LL] * 4 + _SHAPE + [_PTR] * 3)
    lib.care_flash_fwd_key_splits.argtypes = _SHAPE + [_INT]
    lib.care_flash_fwd_key_splits.restype = ctypes.c_int
    return lib


def fwd_key_splits(q, k) -> int:
    """The number of blocks (a thread-block cluster) over which the forward
    kernel splits each (batch, head)'s keys for these operands: 1 unless the
    decode variant would leave the card part empty."""
    b, h, lq, dh = q.shape
    n = _fwd_library().care_flash_fwd_key_splits(
        b, h, lq, k.shape[2], dh, int(q.dtype == torch.bfloat16))
    if n < 0:
        _raise_on(n, "flash attention forward", dh)
    return n


_BWD_HEAD = [_PTR] * 4 + [_LL] * 3 + [_PTR] * 3 + _SHAPE


@functools.cache
def _dq_library():
    # q, k, v, bias, 3 bias strides, lse, do, delta, shape, dq, stream
    return _bind(_build.load("flash_attention_bwd_dq"), "care_flash_bwd_dq",
                 _BWD_HEAD + [_PTR] * 2)


@functools.cache
def _dkv_library():
    # ..., shape, dk, dv, dbias, stream
    return _bind(_build.load("flash_attention_bwd_dkv"), "care_flash_bwd_dkv",
                 _BWD_HEAD + [_PTR] * 4)


def _check_operands(q, k, v, bias, query_extent: bool):
    """What the kernels ask of q [B, H, Lq, Dh], k, v [B, H, Lk, Dh] and the
    bias (f32, broadcastable to [B, H, Lq or 1, Lk])."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention kernels take f32 or bf16, not "
                        f"{q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("query, key and value must share one dtype")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"query {tuple(q.shape)}, key {tuple(k.shape)} and "
                         f"value {tuple(v.shape)} must be [B, H, Lq, Dh] and "
                         "[B, H, Lk, Dh]")
    if q.shape[3] not in _HEAD_WIDTHS:
        raise ValueError(f"flash attention kernels take a head width of "
                         f"{_HEAD_WIDTHS}, not {q.shape[3]}")
    if q.shape[2] < 1 or k.shape[2] < 1:
        raise ValueError("flash attention needs at least one query and key")
    for name, t in (("query", q), ("key", k), ("value", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous tensor on "
                             f"{q.device}")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.device != q.device:
            raise TypeError(f"the bias must be an f32 tensor on {q.device}")
        if not query_extent and bias.dim() >= 2 and bias.shape[-2] != 1:
            raise ValueError("the backward kernels take a bias without a "
                             f"query extent, not {tuple(bias.shape)}")


def _raise_on(rc: int, what: str, dh: int):
    if rc == -1:
        raise ValueError(f"{what} kernel has no instance for head width {dh}")
    if rc == -2:
        raise RuntimeError(f"{what} kernel: a cluster of the blocks that "
                           "split the keys cannot be resident on this card")
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


def _flash_fwd_cuda(q, k, v, bias):
    """The kernel's (out, lse): the contract of ``_flash_fwd_plain``. One
    launch on the current stream, without syncing."""
    global fwd_launches, fwd_bf16_launches
    _check_operands(q, k, v, bias, query_extent=True)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    strides = (0, 0, 0, 0)
    if bias is not None:
        bias = _expanded_bias(bias, b, h, lq, lk)
        strides = bias.stride()
    out = torch.empty_like(q)
    lse = torch.empty((b, h, lq), dtype=torch.float32, device=q.device)
    lib = _fwd_library()
    fn = (lib.care_flash_fwd_f32 if q.dtype == torch.float32
          else lib.care_flash_fwd_bf16)
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), *strides, b, h, lq, lk,
            dh, out.data_ptr(), lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, "flash attention forward", dh)
    fwd_launches += 1
    fwd_bf16_launches += int(q.dtype == torch.bfloat16)
    return out, lse


def _flash_bwd_cuda(q, k, v, bias, lse, do, delta):
    """The kernels' (dq, dk, dv, dbias [B, H, 1, Lk] or None): the contract
    of ``_flash_bwd_plain``. One launch of the dq kernel and one of the
    dk/dv/dbias kernel on the current stream, without syncing."""
    global dq_launches, dkv_launches
    _check_operands(q, k, v, bias, query_extent=False)
    b, h, lq, dh = q.shape
    lk = k.shape[2]
    if do.shape != q.shape or do.dtype != q.dtype or do.device != q.device \
            or not do.is_contiguous():
        raise ValueError(f"the output's gradient must be a contiguous "
                         f"{q.dtype} tensor of shape {tuple(q.shape)} on "
                         f"{q.device}")
    for name, t in (("lse", lse), ("delta", delta)):
        if tuple(t.shape) != (b, h, lq) or t.dtype != torch.float32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous f32 tensor of "
                             f"shape {(b, h, lq)} on {q.device}")
    strides = (0, 0, 0)
    dbias = None
    if bias is not None:
        bias = _expanded_bias(bias, b, h, 1, lk)
        sb, sh, _, sk = bias.stride()
        strides = (sb, sh, sk)
        dbias = torch.empty((b, h, 1, lk), dtype=torch.float32,
                            device=q.device)
    head = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), *strides,
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), b, h, lq, lk, dh)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    suffix = "f32" if q.dtype == torch.float32 else "bf16"
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = getattr(_dq_library(), "care_flash_bwd_dq_" + suffix)(
        *head, dq.data_ptr(), stream)
    _raise_on(rc, "flash attention dq", dh)
    dq_launches += 1
    rc = getattr(_dkv_library(), "care_flash_bwd_dkv_" + suffix)(
        *head, dk.data_ptr(), dv.data_ptr(),
        None if dbias is None else dbias.data_ptr(), stream)
    _raise_on(rc, "flash attention dk/dv", dh)
    dkv_launches += 1
    return dq, dk, dv, dbias


# ---------------------------------------------------------------------------
# the differentiable function
# ---------------------------------------------------------------------------

def _unbroadcast(grad, shape):
    """Sum ``grad`` down to ``shape`` (the reverse of broadcasting), also to
    a target of lower rank."""
    while grad.dim() > len(shape):
        grad = grad.sum(dim=0)
    axes = [i for i, (g, s) in enumerate(zip(grad.shape, shape))
            if s == 1 and g != 1]
    if axes:
        grad = grad.sum(dim=axes, keepdim=True)
    return grad.reshape(shape)


def _on_cuda(t) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"no flash attention path for device {t.device}")


class _Flash(torch.autograd.Function):

    @staticmethod
    def forward(ctx, query, key, value, bias, backward, block_q, block_k):
        global plain_forward_calls
        q, k, v = query.contiguous(), key.contiguous(), value.contiguous()
        if _on_cuda(q):
            out, lse = _flash_fwd_cuda(
                q, k, v, None if bias is None else bias.to(torch.float32))
        else:
            out, lse = _flash_fwd_plain(q, k, v, bias, block_q, block_k)
            plain_forward_calls += 1
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.rule = backward
        ctx.blocks = (block_q, block_k)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        b, h, lq, _ = q.shape
        lk = k.shape[2]
        use_kernel = (ctx.rule == "kernel" or (
            ctx.rule == "auto" and b * h * lq * lk * 4 > _BWD_KERNEL_MIN_BYTES))
        if bias is not None and bias.dim() >= 2 and bias.shape[-2] != 1:
            # a bias with a query extent (relative-position tables) needs
            # the full [Lq, Lk] bias gradient: always the dense rule
            use_kernel = False
        if not use_kernel:
            grads = _dense_backward(q, k, v, bias, do)
        else:
            do = do.contiguous()
            delta = (do.float() * out.float()).sum(dim=-1)
            if _on_cuda(q):
                dq, dk, dv, db = _flash_bwd_cuda(
                    q, k, v, None if bias is None else bias.to(torch.float32),
                    lse, do, delta)
            else:
                dq, dk, dv, db = _flash_bwd_plain(q, k, v, bias, lse, do,
                                                  delta, *ctx.blocks)
            if db is not None:
                db = _unbroadcast(db, bias.shape).to(bias.dtype)
            grads = (dq, dk, dv, db)
        return tuple(g if need else None for g, need in
                     zip(grads, ctx.needs_input_grad[:4])) + (None,) * 3


def _dense_backward(q, k, v, bias, do):
    """The dense rule: autograd of the plain recompute."""
    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    if bias is not None:
        leaves.append(bias.detach().requires_grad_(True))
    with torch.enable_grad():
        out = _attention_reference(*leaves[:3],
                                   leaves[3] if bias is not None else None)
    grads = torch.autograd.grad(out, leaves, do)
    return tuple(grads) if bias is not None else tuple(grads) + (None,)


def flash_attention(query, key, value, bias=None, backward: str = "auto",
                    block_q: int = None, block_k: int = None):
    """Flash attention. query: [B, H, Lq, Dh]; key, value: [B, H, Lk, Dh];
    ``bias``: anything that broadcasts to [B, H, Lq, Lk] and already holds
    the masks as 0 / -1e9. Returns the context [B, H, Lq, Dh] in ``query``'s
    dtype, equal to plain softmax attention.

    Differentiable in query, key, value and the bias. ``backward`` picks
    the rule, with the JAX package's choices under the port's names:

    * ``"dense"`` (the JAX package's ``"xla"``): autograd of a plain
      recompute, which keeps the [Lq, Lk] probabilities between its forward
      and backward;
    * ``"kernel"`` (``"pallas"``): the dq and the dk/dv/dbias kernels, which
      recompute the probabilities tile by tile from the forward's
      log-sum-exp and store nothing of size [Lq, Lk];
    * ``"auto"``: the kernels once the probabilities would take more than
      ``_BWD_KERNEL_MIN_BYTES``, else the dense rule.

    A bias with a query extent other than 1 always takes the dense rule.
    Query, key and value of different dtypes are promoted to one first. On a
    CUDA tensor the forward, and the kernel rule of the backward, launch
    the hand-written kernels (head widths 32, 64 and 128; f32 or bf16) or
    raise; a CPU tensor takes their plain versions, whose blocks ``block_q``
    and ``block_k`` set (the kernels choose their own tiles).
    """
    if backward not in ("auto", "kernel", "dense"):
        raise ValueError(f"backward must be auto, kernel or dense, not "
                         f"{backward!r}")
    # mixed operands (an f32 query against a bf16 cache of keys and values,
    # the half-precision decode of a model whose decoder runs f32) compute
    # in their promoted dtype; the kernels take one dtype
    if not query.dtype == key.dtype == value.dtype:
        dtype = torch.promote_types(
            torch.promote_types(query.dtype, key.dtype), value.dtype)
        query, key, value = query.to(dtype), key.to(dtype), value.to(dtype)
    return _Flash.apply(query, key, value, bias, backward,
                        block_q or _PLAIN_BLOCK, block_k or _PLAIN_BLOCK)
