// Helpers shared by the port's kernels: the vocab kernels (fused_head_topk.cu,
// vocab_argmax_lse.cu, fused_xent_bwd_dh.cu, fused_xent_bwd_dw.cu, through
// tile_logits_tc.cuh) and the flash-attention kernels (flash_tile.cuh).
//
// Conversions between f32 and the operand types; the rounding rule of the
// vocab logits (with bf16 inputs the product accumulates in f32, is rounded
// to bf16, the bias is added in bf16, and the result is taken to f32: the
// rule of the TPU kernels `_stats_pallas`, `_argmax_lse_kernel`,
// `_dlogits_block`); the (value, id) ranking that sends ties to the lowest
// vocab id whatever order tiles are merged in; and the online-softmax merge.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace care {

constexpr int THREADS = 256;    // a block of the kernels that take the default

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void from_f32(float x, float* out) { *out = x; }
__device__ __forceinline__ void from_f32(float x, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(x);
}

// x rounded to T's precision, as f32
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// logit of one column from its f32 accumulator
__device__ __forceinline__ float epilogue(float acc, const float* b, int col) {
  return b ? acc + b[col] : acc;
}
__device__ __forceinline__ float epilogue(float acc, const __nv_bfloat16* b,
                                          int col) {
  float x = __bfloat162float(__float2bfloat16_rn(acc));
  if (b) x = __bfloat162float(__float2bfloat16_rn(x + __bfloat162float(b[col])));
  return x;
}

constexpr int NO_ID = 0x7fffffff;

// (x, id) ranks before (y, jd): larger value first, then lower id
__device__ __forceinline__ bool ranks_before(float x, int id, float y, int jd) {
  return x > y || (x == y && id < jd);
}

__device__ __forceinline__ void warp_best(float& v, int& id) {
  for (int o = 16; o > 0; o >>= 1) {
    float ov = __shfl_xor_sync(0xffffffffu, v, o);
    int oid = __shfl_xor_sync(0xffffffffu, id, o);
    if (ranks_before(ov, oid, v, id)) { v = ov; id = oid; }
  }
}

// online-softmax merge of (m2, s2) into (m, s); m = -inf means empty
__device__ __forceinline__ void merge_stats(float& m, float& s, float m2,
                                            float s2) {
  if (m2 == -INFINITY) return;
  if (m == -INFINITY) { m = m2; s = s2; return; }
  float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

}  // namespace care
