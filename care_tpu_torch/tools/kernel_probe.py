"""What holds the tensor-core vocab kernels back, measured on the card.

Two probes:

* ``mma``: the rate of ``mma.sync`` on this card, TF32 m16n8k8 and bf16
  m16n8k16, with 4, 8 and 16 warps per SM, each warp running eight
  independent accumulator chains. It is the ceiling of the route that
  ``csrc/tile_logits_tc.cuh`` took, beside the data-sheet peaks of dense
  ``wgmma`` (495 TFLOP/s TF32, 989 bf16).
* ``ablate``: K1 (``csrc/fused_head_topk.cu``) and K3b
  (``csrc/fused_xent_bwd_dw.cu``) built again with one part taken out, each
  timed at the shapes ``chip_smoke.py`` times them. A variant's time says
  what the part costs where the others still run; the results of a
  variant are wrong by design and are not looked at.

Variants are text patches of copies of ``csrc/`` (each must match once, so a
patch that no longer fits the source fails loudly), built with the flags of
``ops/_build.py`` into ``build/probe/``. Run from the repository's root on a
machine with a card::

    python3 -m care_tpu_torch.tools.kernel_probe

It prints the card and its power limit, then one line a reading.
"""

import concurrent.futures
import ctypes
import os
import shutil
import subprocess

import torch

from care_tpu_torch.ops import _build
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


def _variant_source(name: str, variant: str) -> str:
    """A copy of csrc/ with the variant's patches, and its kernel's path."""
    out = os.path.join(PROBE_DIR, f"{name}.{variant}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC_DIR, out)
    for fname, old, new in VARIANTS[name][variant]:
        path = os.path.join(out, fname)
        with open(path) as f:
            text = f.read()
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}.{variant}: {old!r} occurs "
                               f"{text.count(old)} times in {fname}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return os.path.join(out, name + ".cu")


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
    return lambda: _call(fn, h.data_ptr(), W.data_ptr(), None, rows, H, V, K,
                         *(t.data_ptr() for t in bufs), stream)


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
    return lambda: _call(fn, h.data_ptr(), W.data_ptr(), None,
                         *(v.data_ptr() for v in vectors), labels.data_ptr(),
                         rows, H, V, dW.data_ptr(), db.data_ptr(), stream)


def probe_ablation(libs) -> None:
    shapes = {
        "fused_head_topk": [
            ("K1 [320, 512] x [11000, 512]", dtype,
             lambda lib, d=dtype: _head_call(lib, d))
            for dtype in (torch.float32, torch.bfloat16)],
        "fused_xent_bwd_dw": [
            (f"K3b [1856, {H}] x [11000, {H}]", dtype,
             lambda lib, d=dtype, H=H: _dw_call(lib, d, H))
            for H, dtype in ((512, torch.float32), (512, torch.bfloat16),
                             (768, torch.float32))],
    }
    for name, cases in shapes.items():
        for label, dtype, make in cases:
            for variant in VARIANTS[name]:
                ms = _time_ms(make(libs[name, variant]))
                print(f"ablate {label} {str(dtype)[6:]} {variant}: "
                      f"{ms:.4f} ms")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_probe: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    os.makedirs(PROBE_DIR, exist_ok=True)
    mma_src = os.path.join(PROBE_DIR, "mma_rate.cu")
    with open(mma_src, "w") as f:
        f.write(_MMA_SOURCE)
    jobs = {("mma", "base"): (mma_src, os.path.join(PROBE_DIR,
                                                     "libmma_rate.so"))}
    for name, variants in VARIANTS.items():
        for variant in variants:
            src = _variant_source(name, variant)
            jobs[name, variant] = (src, os.path.join(
                os.path.dirname(src), f"lib{name}.so"))
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        built = dict(zip(jobs, pool.map(lambda j: _compile(*j),
                                        jobs.values())))
    libs = {}
    for key, path in built.items():
        lib = ctypes.CDLL(path)
        if key[0] == "fused_head_topk":
            for fn in (lib.care_fused_head_topk_f32,
                       lib.care_fused_head_topk_bf16):
                fn.argtypes, fn.restype = fht._ARGTYPES, ctypes.c_int
            lib.care_fused_head_topk_tile_cols.restype = ctypes.c_int
        elif key[0] == "fused_xent_bwd_dw":
            for fn in (lib.care_xent_bwd_dw_f32, lib.care_xent_bwd_dw_bf16):
                fn.argtypes = fx._BWD_ROWS + [ctypes.c_void_p] * 3
                fn.restype = ctypes.c_int
        else:
            lib.care_mma_rate.argtypes = ([ctypes.c_int] * 4
                                          + [ctypes.c_void_p] * 2)
            lib.care_mma_rate.restype = ctypes.c_int
        libs[key] = lib
    probe_mma(libs["mma", "base"])
    probe_ablation(libs)


if __name__ == "__main__":
    main()
