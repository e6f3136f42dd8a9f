"""What holds the tensor-core kernels back, measured on the card.

Three probes:

* ``mma``: the rate of ``mma.sync`` on this card, TF32 m16n8k8 and bf16
  m16n8k16, with 4, 8 and 16 warps per SM, each warp running eight
  independent accumulator chains. It is the ceiling of the route that
  ``csrc/tile_logits_tc.cuh`` took, beside the data-sheet peaks of dense
  ``wgmma`` (495 TFLOP/s TF32, 989 bf16).
* ``sass``: the count of tensor-core instructions (``HMMA``) in the
  machine code of each flash-attention kernel, by ``cuobjdump -sass``: the
  two backward kernels reach the tensor cores, the forward (K4a, on the
  CUDA cores) does not.
* ``ablate``: K1 (``csrc/fused_head_topk.cu``), K2
  (``csrc/vocab_argmax_lse.cu``), K3a (``csrc/fused_xent_bwd_dh.cu``), K3b
  (``csrc/fused_xent_bwd_dw.cu``), K4b (``csrc/flash_attention_bwd_dq.cu``)
  and K4c (``csrc/flash_attention_bwd_dkv.cu``) built again with one part
  taken out, each timed at the serving and training shapes (K1 at the
  flagship's serve step, K2-K3b at its train step, the flash kernels at
  the shapes below). A
  variant's time says what the part costs where the others still run; the
  results of a variant are wrong by design and are not looked at.

Variants are text patches of copies of ``csrc/`` (each must match once, so a
patch that no longer fits the source fails loudly), built with the flags of
``ops/_build.py`` into ``build/probe/``. Run from the repository's root on a
machine with a card::

    python3 -m care_tpu_torch.tools.kernel_probe

It prints the card and its power limit, then one line a reading. With
``--against DIR`` it instead builds the four vocab kernels and the three
flash-attention kernels from ``DIR``, a copy of ``csrc/`` with the same C
interfaces (a parent commit's, say), and from this tree, compares their
outputs (bit-equal, else the largest difference), and times them in turns
(base, new, new, base) at the same shapes: a change to a kernel measured
against its parent in one call on one card.
"""

import argparse
import concurrent.futures
import ctypes
import functools
import os
import re
import shutil
import subprocess

import torch

from care_tpu_torch.ops import _build
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops import fused_head_topk as fht
from care_tpu_torch.ops import fused_xent as fx

PROBE_DIR = os.path.join(_build.BUILD_DIR, "probe")

# the tensor-core instructions of tile_logits_tc.cuh's mma(), and what the
# variants put in their place
_THREE_TF32 = ("  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);\n"
               "  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);\n"
               "  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);\n")
_ONE_BF16 = "  mma_bf16(c, a.v, b.v[0], b.v[1]);\n"
# no tensor-core instruction; the operands' loads and the hi/lo split stay,
# since the result still depends on every fragment word
_NO_MMA = [
    ("tile_logits_tc.cuh", _THREE_TF32,
     "  c[0] += __uint_as_float(a.hi[0] ^ a.hi[1] ^ a.hi[2] ^ a.hi[3] ^\n"
     "      a.lo[0] ^ a.lo[1] ^ a.lo[2] ^ a.lo[3] ^ b.hi[0] ^ b.hi[1] ^\n"
     "      b.lo[0] ^ b.lo[1]);\n"),
    ("tile_logits_tc.cuh", _ONE_BF16,
     "  c[0] += __uint_as_float(a.v[0] ^ a.v[1] ^ a.v[2] ^ a.v[3] ^ b.v[0] ^\n"
     "      b.v[1]);\n")]
# one TF32 product for f32 (the two correction products dropped)
_ONE_TF32 = [("tile_logits_tc.cuh", _THREE_TF32,
              "  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);\n")]

VARIANTS = {
    "fused_head_topk": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        # no staging of h and W: the products read what shared memory holds
        "no_load": [
            ("fused_head_topk.cu",
             "  for (int s = 0; s < STAGES - 1; ++s) load(s);\n", ""),
            ("fused_head_topk.cu", "    load(it + STAGES - 1);\n", "")],
        # no per-(row, tile) top-K, max and sum of exp
        "no_epilogue": [("fused_head_topk.cu", "    if (row0 + r < rows) {",
                         "    if (row0 + r < rows && rows < 0) {")],
        "no_merge": [("fused_head_topk.cu", "  merge_kernel<<<",
                      "  if (rows < 0) merge_kernel<<<")],
    },
    "vocab_argmax_lse": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        # no staging of W's chunks: the products read what the ring holds
        "no_load": [
            ("vocab_argmax_lse.cu",
             "  for (int s = 0; s < NST - 1; ++s) load(s);\n", ""),
            ("vocab_argmax_lse.cu", "    load(it + NST - 1);\n", "")],
        # no folding of a tile's logits into the row statistics
        "no_epilogue": [("vocab_argmax_lse.cu",
                         "    if (c != nch - 1) continue;",
                         "    if (c != nch - 1 || rows > 0) continue;")],
        "no_merge": [("vocab_argmax_lse.cu", "  xent_stats_reduce_kernel<<<",
                      "  if (rows < 0) xent_stats_reduce_kernel<<<")],
    },
    "fused_xent_bwd_dh": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        # no dh product (the logits and dlogits stay)
        "no_dh_product": [("fused_xent_bwd_dh.cu", "    if (wh0 < H) {",
                           "    if (wh0 < H && rows < 0) {")],
        "no_exp": [("fused_xent_bwd_dh.cu", "expf(logit - v_lse[u])",
                    "(logit - v_lse[u])")],
        # the resident variant's next W vocab tiles not loaded
        "no_w_refill": [("fused_xent_bwd_dh.cu",
                         "if (!STREAM && t + VSPLIT < vtiles)",
                         "if (false)")],
    },
    "fused_xent_bwd_dw": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        # no dW product (the logits, dlogits and db stay)
        "no_dw_product": [("fused_xent_bwd_dw.cu", "    if (wh0 < H) {",
                           "    if (wh0 < H && rows < 0) {")],
        "no_exp": [("fused_xent_bwd_dw.cu", "expf(logit - v_lse[u])",
                    "(logit - v_lse[u])")],
        # the resident variant's next h row tiles not loaded
        "no_h_refill": [("fused_xent_bwd_dw.cu",
                         "if (!STREAM && t + DSPLIT < row_tiles)",
                         "if (false)")],
    },
}

# the flash backward kernels: the ring's next tile waited for at once, so
# that no load overlaps a product; no split of the streamed tile into TF32
# planes (f32); no gradient products (the scores and g stay)
def _no_ring(fname):
    return [(fname, "    load(t + C::STAGES - 1);\n",
             "    load(t + C::STAGES - 1);\n    tc::cp_async_wait(0);\n")]


_FWD = "flash_attention_fwd.cu"
VARIANTS.update({
    "flash_attention_fwd": {
        "base": [],
        # the large-query variant's products
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        # both variants' next tiles waited for at once
        "no_ring": _no_ring(_FWD) + [
            (_FWD, "    load(i + STAGES - 1);\n",
             "    load(i + STAGES - 1);\n    tc::cp_async_wait(0);\n")],
        "no_split": [(_FWD,
                      "      tc::split_in_place<BKV, DH, LD, NT>(Kt, lo, "
                      "tid);\n      tc::split_in_place<BKV, DH, LD, NT>(Vt, "
                      "lo + C::TILE, tid);\n", "")],
        # the decode variant: no cluster split of the keys; a split up to
        # four times wider; its products on the other engine (f32 on
        # mma.sync, bf16 on the CUDA cores)
        "no_cluster": [(_FWD, "constexpr int MAX_SPLITS = 8;",
                        "constexpr int MAX_SPLITS = 1;")],
        "more_splits": [(_FWD, "constexpr int SPLIT_BLOCKS_PER_SM = 2;",
                         "constexpr int SPLIT_BLOCKS_PER_SM = 8;")],
        "eight_warps": [(_FWD, "constexpr int DEC_WARPS = 4;",
                         "constexpr int DEC_WARPS = 8;")],
        "three_stages": [(_FWD, "  static constexpr int STAGES = 2;\n",
                          "  static constexpr int STAGES = 3;\n")],
        "decode_products_swapped": [(_FWD, "  return sizeof(T) == 2;\n",
                                     "  return sizeof(T) == 4;\n")],
    },
    "flash_attention_bwd_dq": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        "no_ring": _no_ring("flash_attention_bwd_dq.cu"),
        "no_split": [("flash_attention_bwd_dq.cu",
                      "      tc::split_in_place<BKV, DH, LD, NT>(Kt, lo, "
                      "tid);\n      tc::split_in_place<BKV, DH, LD, NT>(Vt, "
                      "lo + C::TILE, tid);\n", "")],
        "no_dq_product": [("flash_attention_bwd_dq.cu",
                           "    tc::acc_product<T, NF, NO>(acc, s, Kp, lane);",
                           "    acc[0][0] += s[0][0] + s[NF - 1][3];")],
    },
    "flash_attention_bwd_dkv": {
        "base": [],
        "no_mma": _NO_MMA,
        "one_tf32": _ONE_TF32,
        "no_ring": _no_ring("flash_attention_bwd_dkv.cu"),
        "no_split": [("flash_attention_bwd_dkv.cu",
                      "      tc::split_in_place<BQ, DH, LD, NT>(Qt, lo, tid);\n"
                      "      tc::split_in_place<BQ, DH, LD, NT>(dOt, lo + "
                      "C::TILE, tid);\n", "")],
        "no_dbias": [("flash_attention_bwd_dkv.cu",
                      "const bool want_db = dbias != nullptr;",
                      "const bool want_db = false;")],
        "no_dkv_products": [
            ("flash_attention_bwd_dkv.cu",
             "    tc::acc_product<T, NF, NO>(acc_v, st, dOp, lane);\n"
             "    tc::acc_product<T, NF, NO>(acc_k, dpt, Qp, lane);",
             "    acc_v[0][0] += st[0][0] + st[NF - 1][3];\n"
             "    acc_k[0][0] += dpt[0][0] + dpt[NF - 1][3];")],
    },
})

_MMA_SOURCE = r"""
#include <cuda_runtime.h>

template <bool BF16>
__global__ void mma_loop(float* out, int iters) {
  const unsigned one = BF16 ? 0x3f803f80u : 0x3f800000u;  // 1.0 (pairs)
  unsigned a[4] = {one, one, one, one};
  const unsigned b0 = one ^ (threadIdx.x & 1), b1 = one;
  float c[8][4] = {};
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (BF16)
        asm volatile(
            "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
      else
        asm volatile(
            "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
            "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
            : "+f"(c[j][0]), "+f"(c[j][1]), "+f"(c[j][2]), "+f"(c[j][3])
            : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
    }
  }
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int care_mma_rate(int bf16, int blocks, int threads, int iters,
                             void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16)
    mma_loop<true><<<blocks, threads, 0, st>>>(static_cast<float*>(out),
                                                iters);
  else
    mma_loop<false><<<blocks, threads, 0, st>>>(static_cast<float*>(out),
                                                 iters);
  return static_cast<int>(cudaGetLastError());
}
"""


def _compile(src: str, lib: str) -> str:
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, src]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    return lib


def _variant_source(name: str, variant: str) -> tuple:
    """A copy of csrc/ with the variant's patches: its kernel's source and
    library paths."""
    src, lib = _copy_sources(_build.CSRC_DIR, variant, name)
    for fname, old, new in VARIANTS[name][variant]:
        path = os.path.join(os.path.dirname(src), fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}.{variant}: {old!r} occurs "
                               f"{text.count(old)} times in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return src, lib


def _time_ms(fn, n=50, warm=5):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def _call(fn, *args):
    rc = fn(*args)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def probe_mma(lib) -> None:
    stream = torch.cuda.current_stream().cuda_stream
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    iters = 4096
    for bf16, kind, flops_per_mma in ((0, "tf32 m16n8k8", 2 * 16 * 8 * 8),
                                      (1, "bf16 m16n8k16", 2 * 16 * 8 * 16)):
        for warps in (4, 8, 16):
            out = torch.empty(sms * warps * 32, device="cuda")
            ms = _time_ms(lambda: _call(lib.care_mma_rate, bf16, sms,
                                        warps * 32, iters, out.data_ptr(),
                                        stream), n=10, warm=2)
            flops = sms * warps * iters * 8 * flops_per_mma
            print(f"mma.sync {kind}: {warps} warps/SM on {sms} SMs: "
                  f"{ms:.4f} ms, {flops / ms / 1e9:.1f} TFLOP/s")


def _launcher(run, outputs):
    """``run`` (one launch), with the tensors it writes as ``run.outputs``."""
    run.outputs = outputs
    return run


def _head_call(lib, dtype, rows=320, H=512, V=11000, K=5):
    g = torch.Generator().manual_seed(1)
    h = torch.randn((rows, H), generator=g).to("cuda", dtype)
    W = (torch.randn((V, H), generator=g) * 0.05).to("cuda", dtype)
    n_tiles = -(-V // lib.care_fused_head_topk_tile_cols())
    f32, i32 = dict(device="cuda"), dict(device="cuda", dtype=torch.int32)
    bufs = [torch.empty((rows, n_tiles), **f32),
            torch.empty((rows, n_tiles), **f32),
            torch.empty((rows, n_tiles, K), **f32),
            torch.empty((rows, n_tiles, K), **i32),
            torch.empty((rows,), **f32), torch.empty((rows,), **f32),
            torch.empty((rows, K), **f32), torch.empty((rows, K), **i32)]
    fn = (lib.care_fused_head_topk_f32 if dtype == torch.float32
          else lib.care_fused_head_topk_bf16)
    stream = torch.cuda.current_stream().cuda_stream
    return _launcher(lambda: _call(
        fn, h.data_ptr(), W.data_ptr(), None, rows, H, V, K,
        *(t.data_ptr() for t in bufs), stream), bufs[4:])


def _k2_call(lib, dtype, H, rows=1856, V=11000):
    g = torch.Generator().manual_seed(5)
    h = torch.randn((rows, H), generator=g).to("cuda", dtype)
    W = (torch.randn((V, H), generator=g) * 0.05).to("cuda", dtype)
    labels = torch.randint(0, V, (rows,), generator=g).int().cuda()
    n_parts = lib.care_vocab_argmax_lse_parts(rows, V)
    f32, i32 = dict(device="cuda"), dict(device="cuda", dtype=torch.int32)
    parts = [torch.empty((rows, n_parts), **f32),
             torch.empty((rows, n_parts), **f32),
             torch.empty((rows, n_parts), **i32),
             torch.empty((rows, n_parts), **f32)]
    outs = [torch.empty((rows,), **i32)] + [torch.zeros((rows,), **f32)
                                            for _ in range(4)]
    fn = (lib.care_vocab_argmax_lse_f32 if dtype == torch.float32
          else lib.care_vocab_argmax_lse_bf16)
    stream = torch.cuda.current_stream().cuda_stream
    return _launcher(lambda: _call(
        fn, h.data_ptr(), W.data_ptr(), None, labels.data_ptr(), rows, H, V, 1,
        *(t.data_ptr() for t in parts + outs), stream), outs)


def _dh_call(lib, dtype, H, rows=1856, V=11000):
    g = torch.Generator().manual_seed(5)
    h = torch.randn((rows, H), generator=g).to("cuda", dtype)
    W = (torch.randn((V, H), generator=g) * 0.05).to("cuda", dtype)
    vectors = [torch.rand((rows,), generator=g).cuda() for _ in range(4)]
    labels = torch.randint(0, V, (rows,), generator=g).int().cuda()
    dh = torch.empty_like(h)
    fn = (lib.care_xent_bwd_dh_f32 if dtype == torch.float32
          else lib.care_xent_bwd_dh_bf16)
    stream = torch.cuda.current_stream().cuda_stream
    return _launcher(lambda: _call(
        fn, h.data_ptr(), W.data_ptr(), None,
        *(v.data_ptr() for v in vectors), labels.data_ptr(), rows, H, V,
        dh.data_ptr(), stream), [dh])


def _dw_call(lib, dtype, H, rows=1856, V=11000):
    g = torch.Generator().manual_seed(5)
    h = torch.randn((rows, H), generator=g).to("cuda", dtype)
    W = (torch.randn((V, H), generator=g) * 0.05).to("cuda", dtype)
    vectors = [torch.rand((rows,), generator=g).cuda() for _ in range(4)]
    labels = torch.randint(0, V, (rows,), generator=g).int().cuda()
    dW, db = torch.empty_like(W), torch.empty((V,), device="cuda")
    fn = (lib.care_xent_bwd_dw_f32 if dtype == torch.float32
          else lib.care_xent_bwd_dw_bf16)
    stream = torch.cuda.current_stream().cuda_stream
    return _launcher(lambda: _call(
        fn, h.data_ptr(), W.data_ptr(), None,
        *(v.data_ptr() for v in vectors), labels.data_ptr(), rows, H, V,
        dW.data_ptr(), db.data_ptr(), stream), [dW, db])


# the flash kernels' shapes, [B, H, Lq, Lk, Dh], hybrid bias: the square
# shape (all three kernels), the long-key decode step at batch 64 and at
# the ragged batch of 17 (K4a); those of tests/torch_card_cases.py
SQUARE = (4, 8, 1568, 1568, 64)
DECODE = (64, 8, 5, 1654, 64)
DECODE_RAGGED = (17, 8, 5, 1654, 64)


@functools.cache
def _flash_operands(dtype, shape):
    """q, k, v, do [B, H, L, Dh], a [1, H, 1, Lk] bias with a -1e9 tail, and
    the plain forward's lse and delta: the same operands for K4b and K4c
    whichever tree's K4a is built, so that only a backward kernel's own
    change shows in its outputs."""
    b, h, lq, lk, dh = shape
    g = torch.Generator().manual_seed(41)
    q, k, v, do = (torch.randn((b, h, n, dh), generator=g).to("cuda", dtype)
                   for n in (lq, lk, lk, lq))
    bias = torch.randn((1, h, 1, lk), generator=g) * 0.5
    bias[..., -lk // 4:] = -1e9
    bias = bias.cuda()
    out, lse = fa._flash_fwd_plain(q, k, v, bias)
    delta = (do.float() * out.float()).sum(-1)
    return q, k, v, do, bias, lse, delta


def _flash_call(name):
    """What makes the launcher of flash kernel ``name`` at a shape
    [B, H, Lq, Lk, Dh]."""
    def build(lib, dtype, shape):
        b, h, lq, lk, dh = shape
        q, k, v, do, bias, lse, delta = _flash_operands(dtype, shape)
        suffix = "f32" if dtype == torch.float32 else "bf16"
        stream = torch.cuda.current_stream().cuda_stream
        f32 = dict(device="cuda", dtype=torch.float32)
        if name == "flash_attention_fwd":
            outs = [torch.empty_like(q), torch.empty((b, h, lq), **f32)]
            fn = getattr(lib, "care_flash_fwd_" + suffix)
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    0, bias.stride(1), 0, bias.stride(3), b, h, lq, lk, dh)
        else:
            args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
                    0, bias.stride(1), bias.stride(3), lse.data_ptr(),
                    do.data_ptr(), delta.data_ptr(), b, h, lq, lk, dh)
            if name == "flash_attention_bwd_dq":
                outs = [torch.empty_like(q)]
                fn = getattr(lib, "care_flash_bwd_dq_" + suffix)
            else:
                outs = [torch.empty_like(k), torch.empty_like(v),
                        torch.empty((b, h, lk), **f32)]
                fn = getattr(lib, "care_flash_bwd_dkv_" + suffix)
        return _launcher(lambda: _call(
            fn, *args, *(t.data_ptr() for t in outs), stream), outs)
    return build


# each kernel's cases: (label, dtype, H, or the flash kernels' shape)
SHAPES = {
    "fused_head_topk": [("K1 [320, 512] x [11000, 512]", dtype, 512)
                        for dtype in (torch.float32, torch.bfloat16)],
    **{name: [(f"{kid} [1856, {H}] x [11000, {H}]", dtype, H)
              for H, dtype in ((512, torch.float32), (512, torch.bfloat16),
                               (768, torch.float32))]
       for name, kid in (("vocab_argmax_lse", "K2"),
                         ("fused_xent_bwd_dh", "K3a"),
                         ("fused_xent_bwd_dw", "K3b"))},
}
FLASH_IDS = {"flash_attention_fwd": "K4a", "flash_attention_bwd_dq": "K4b",
             "flash_attention_bwd_dkv": "K4c"}
SHAPES.update({
    name: [(f"{kid} {list(shape[:3])} x {shape[3]} keys, Dh {shape[4]}",
            dtype, shape)
           for shape in ((DECODE, DECODE_RAGGED, SQUARE)
                         if name == "flash_attention_fwd" else (SQUARE,))
           for dtype in (torch.float32, torch.bfloat16)]
    for name, kid in FLASH_IDS.items()})
CALLS = {"fused_head_topk": lambda lib, dtype, H: _head_call(lib, dtype),
         "vocab_argmax_lse": _k2_call, "fused_xent_bwd_dh": _dh_call,
         "fused_xent_bwd_dw": _dw_call,
         **{name: _flash_call(name) for name in FLASH_IDS}}


def probe_sass(libs) -> None:
    """HMMA instructions in each flash kernel's machine code, by entry
    function (template instance)."""
    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    for name in FLASH_IDS:
        if (name, "base") not in libs:
            continue
        sass = subprocess.run([cuobjdump, "-sass", libs[name, "base"]._name],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {}
        function = None
        for line in sass.splitlines():
            if "Function : " in line:
                function = line.split("Function : ")[1].strip()
                counts[function] = 0
            elif function is not None and "HMMA" in line:
                counts[function] += 1
        print(f"sass {FLASH_IDS[name]} {name}: HMMA instructions by entry "
              "function: " + ", ".join(f"{_short(f)} {n}"
                                       for f, n in counts.items()))


def _short(mangled: str) -> str:
    """name<type, template integers> of a mangled kernel instance name."""
    found = re.search(r"([a-z_]*kernel)I(f|13__nv_bfloat16)((?:Li\d+E)+)",
                      mangled)
    if not found:
        return mangled
    ints = re.findall(r"Li(\d+)E", found[3])
    return (f"{found[1]}<{'f32' if found[2] == 'f' else 'bf16'}, "
            f"{', '.join(ints)}>")


def probe_ablation(libs) -> None:
    for name, cases in SHAPES.items():
        if name not in VARIANTS:
            continue
        for label, dtype, H in cases:
            for variant in VARIANTS[name]:
                if (name, variant) not in libs:
                    continue
                ms = _time_ms(CALLS[name](libs[name, variant], dtype, H))
                print(f"ablate {label} {str(dtype)[6:]} {variant}: "
                      f"{ms:.4f} ms")


def probe_against(libs, names) -> None:
    """Each kernel of ``names`` built from another copy of the sources
    ("base") and from this tree ("new"): outputs compared bit for bit (else
    the largest difference printed), then times in turns base, new, new,
    base, in one process on one card."""
    for name, cases in SHAPES.items():
        if name not in names:
            continue
        for label, dtype, H in cases:
            runs = {tag: CALLS[name](libs[name, tag], dtype, H)
                    for tag in ("base", "new")}
            for run in runs.values():
                run()
            torch.cuda.synchronize()
            pairs = list(zip(runs["base"].outputs, runs["new"].outputs))
            same = all(torch.equal(x, y) for x, y in pairs)
            diff = max(float((x.float() - y.float()).abs().max())
                       for x, y in pairs)
            times = {"base": [], "new": []}
            for tag in ("base", "new", "new", "base"):
                times[tag].append(_time_ms(runs[tag], n=100, warm=10))
            print(f"against {label} {str(dtype)[6:]}: outputs bit-equal "
                  f"{same}" + ("" if same else f" (max |d| {diff:.3e})")
                  + "; base " + ", ".join(f"{t:.4f}" for t in
                                          times["base"])
                  + " ms; new " + ", ".join(f"{t:.4f}" for t in times["new"])
                  + " ms")


def _bind(name, lib):
    """The argument types of kernel ``name``'s entry points in ``lib``."""
    if name == "fused_head_topk":
        for fn in (lib.care_fused_head_topk_f32,
                   lib.care_fused_head_topk_bf16):
            fn.argtypes, fn.restype = fht._ARGTYPES, ctypes.c_int
        lib.care_fused_head_topk_tile_cols.restype = ctypes.c_int
    elif name == "vocab_argmax_lse":
        for fn in (lib.care_vocab_argmax_lse_f32,
                   lib.care_vocab_argmax_lse_bf16):
            fn.argtypes = fht._ARGMAX_LSE_ARGTYPES
            fn.restype = ctypes.c_int
        lib.care_vocab_argmax_lse_parts.argtypes = [ctypes.c_int] * 2
        lib.care_vocab_argmax_lse_parts.restype = ctypes.c_int
    elif name == "fused_xent_bwd_dh":
        for fn in (lib.care_xent_bwd_dh_f32, lib.care_xent_bwd_dh_bf16):
            fn.argtypes = fx._BWD_ROWS + [ctypes.c_void_p] * 2
            fn.restype = ctypes.c_int
    elif name == "fused_xent_bwd_dw":
        for fn in (lib.care_xent_bwd_dw_f32, lib.care_xent_bwd_dw_bf16):
            fn.argtypes = fx._BWD_ROWS + [ctypes.c_void_p] * 3
            fn.restype = ctypes.c_int
    elif name == "flash_attention_fwd":
        fa._bind(lib, "care_flash_fwd",
                 [fa._PTR] * 4 + [fa._LL] * 4 + fa._SHAPE + [fa._PTR] * 3)
    elif name == "flash_attention_bwd_dq":
        fa._bind(lib, "care_flash_bwd_dq", fa._BWD_HEAD + [fa._PTR] * 2)
    elif name == "flash_attention_bwd_dkv":
        fa._bind(lib, "care_flash_bwd_dkv", fa._BWD_HEAD + [fa._PTR] * 4)
    else:
        lib.care_mma_rate.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
        lib.care_mma_rate.restype = ctypes.c_int
    return lib


def _copy_sources(src_dir, tag, name):
    """A copy of ``src_dir`` under build/probe/<name>.<tag>, and the paths of
    its kernel source and library."""
    out = os.path.join(PROBE_DIR, f"{name}.{tag}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src_dir, out)
    return os.path.join(out, name + ".cu"), os.path.join(out, f"lib{name}.so")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--against", metavar="CSRC",
                        help="instead of the mma, sass and ablate probes, "
                             "compare the vocab and flash kernels with those "
                             "built from this copy of csrc/")
    parser.add_argument("--kernels", metavar="NAMES",
                        help="comma-separated kernel names (the csrc/ "
                             "stems): probe only these")
    args = parser.parse_args(argv)
    wanted = set(args.kernels.split(",")) if args.kernels else set(SHAPES)
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    os.makedirs(PROBE_DIR, exist_ok=True)
    jobs = {}
    if args.against:
        for name in wanted:
            jobs[name, "base"] = _copy_sources(args.against, "base", name)
            jobs[name, "new"] = _copy_sources(_build.CSRC_DIR, "new", name)
    else:
        mma_src = os.path.join(PROBE_DIR, "mma_rate.cu")
        with open(mma_src, "w") as f:
            f.write(_MMA_SOURCE)
        jobs["mma", "base"] = (mma_src,
                               os.path.join(PROBE_DIR, "libmma_rate.so"))
        for name in wanted:
            for variant in VARIANTS[name]:
                jobs[name, variant] = _variant_source(name, variant)

    def build(key):
        # a variant that does not build is reported and left out; the base
        # builds and the --against builds must build
        try:
            return _compile(*jobs[key])
        except RuntimeError as e:
            if args.against or key[1] == "base":
                raise
            print(f"build {key[0]}.{key[1]} failed, left out: "
                  + str(e)[-2000:])
            return None

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(build, jobs)))
    libs = {key: _bind(key[0], ctypes.CDLL(path))
            for key, path in built.items() if path}
    if args.against:
        probe_against(libs, wanted)
        return
    probe_mma(libs["mma", "base"])
    probe_sass(libs)
    probe_ablation(libs)


if __name__ == "__main__":
    main()
