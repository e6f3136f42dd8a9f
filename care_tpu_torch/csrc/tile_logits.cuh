// One BM x BN tile of the vocab logits x = h @ W^T (+ b), shared by the
// kernels that stream the vocab projection (fused_head_topk.cu,
// vocab_argmax_lse.cu, fused_xent_bwd_dh.cu, fused_xent_bwd_dw.cu).
//
// h is [rows, H]; W is stored as torch keeps a Linear weight, [V, H], each
// vocab column's H values contiguous; b is [V] or null. The product is a
// plain shared-memory tiled one in f32 on the CUDA cores (no TF32, no tensor
// cores), so that an f32 call rounds like torch's f32 matmul. With bf16
// inputs the product accumulates in f32, is rounded to bf16, the bias is
// added in bf16, and the result is taken to f32: the rule of the TPU
// kernels this replaces (`_stats_pallas`, `_argmax_lse_kernel`,
// `_dlogits_block`). Rows >= rows read as zero rows; columns >= V come out
// as -inf (the TPU kernels padded them with a -1e30 bias instead).
//
// Also here: the (value, id) ranking that sends ties to the lowest vocab id
// whatever order tiles are merged in, and the online-softmax merge.
//
// Thread layout: 256 threads as 16 x 16, thread (tx, ty) owning the TM x TN
// outputs at rows ty + 16 i and columns tx + 16 j.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace care {

constexpr int BM = 64;          // rows per tile
constexpr int BN = 128;         // vocab columns per tile
constexpr int BK = 16;          // depth of one step over the reduced axis
constexpr int THREADS = 256;    // 16 x 16 threads, each owning TM x TN outputs
constexpr int TM = BM / 16;
constexpr int TN = BN / 16;
constexpr int WARPS = THREADS / 32;

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

// The shared memory of one tile; the +1 pads keep the transposing stores
// free of bank conflicts.
struct TileSmem {
  float As[BK][BM + 1];
  float Bs[BK][BN + 1];
  float Cs[BM][BN + 1];
};

// acc[i][j] += sum_kk a(kk, ty + 16 i) * w(kk, tx + 16 j) over one BK step
// already in shared memory
__device__ __forceinline__ void mac_step(float (&acc)[TM][TN],
                                         const float (&As)[BK][BM + 1],
                                         const float (&Bs)[BK][BN + 1],
                                         int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BK; ++kk) {
    float a[TM], w[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) w[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// Fills sm.Cs with the logits of rows [row0, row0 + BM) x columns
// [col0, col0 + BN) and synchronises the block. All THREADS threads call it.
template <typename T>
__device__ __forceinline__ void tile_logits(const T* __restrict__ h,
                                            const T* __restrict__ W,
                                            const T* __restrict__ b, int rows,
                                            int H, int V, int row0, int col0,
                                            TileSmem& sm) {
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < H; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += THREADS) {
      int r = idx / BK, kk = idx % BK;
      int gr = row0 + r, gk = k0 + kk;
      sm.As[kk][r] =
          (gr < rows && gk < H) ? to_f32(h[(size_t)gr * H + gk]) : 0.f;
    }
    for (int idx = tid; idx < BN * BK; idx += THREADS) {
      int c = idx / BK, kk = idx % BK;
      int gc = col0 + c, gk = k0 + kk;
      sm.Bs[kk][c] =
          (gc < V && gk < H) ? to_f32(W[(size_t)gc * H + gk]) : 0.f;
    }
    __syncthreads();
    mac_step(acc, sm.As, sm.Bs, tx, ty);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = tx + 16 * j;
      int gc = col0 + c;
      sm.Cs[ty + 16 * i][c] = gc < V ? epilogue(acc[i][j], b, gc) : -INFINITY;
    }
  __syncthreads();
}

// In place in sm.Cs: logits -> the cross-entropy statistics' gradient
//   d = g_lse * exp(x - lse) + g_label * [col == label] + g_sum,
// rounded to T's precision (the second product takes it in the input type),
// 0 outside rows x V. Synchronises the block.
template <typename T>
__device__ __forceinline__ void tile_dlogits(
    const float* __restrict__ lse, const float* __restrict__ g_lse,
    const float* __restrict__ g_label, const float* __restrict__ g_sum,
    const int* __restrict__ labels, int rows, int V, int row0, int col0,
    TileSmem& sm) {
  for (int idx = threadIdx.x; idx < BM * BN; idx += THREADS) {
    int r = idx / BN, c = idx % BN;
    int gr = row0 + r, gc = col0 + c;
    float d = 0.f;
    if (gr < rows && gc < V) {
      d = g_lse[gr] * expf(sm.Cs[r][c] - lse[gr]) +
          (gc == labels[gr] ? g_label[gr] : 0.f) + g_sum[gr];
      d = round_as(d, static_cast<const T*>(nullptr));
    }
    sm.Cs[r][c] = d;
  }
  __syncthreads();
}

}  // namespace care
