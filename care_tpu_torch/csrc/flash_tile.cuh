// Building blocks of the flash-attention kernels: the forward
// (flash_attention_fwd.cu) and, for their bias and types, the two backward
// kernels (flash_attention_bwd_dq.cu, flash_attention_bwd_dkv.cu), whose
// products run on the tensor cores through tile_logits_tc.cuh.
//
// The forward works on tiles held in shared memory as f32, whatever the
// input type, and multiplies them on the CUDA cores with f32 fused
// multiply-adds (no TF32, no tensor cores), so that an f32 call rounds like
// torch's f32 matmul. A tile is stored either by rows (`stage_rows`:
// tile[r][c]) or transposed (`stage_transposed`: tile[c][r]); every shared
// row is padded by PAD floats, which keeps its start on a 16-byte boundary
// and spreads consecutive rows over the banks. One product covers its two
// matrix products:
//   mac_rows: acc[i][j] += sum_k A[i][k] * B[k][j]   (A by rows, depth inside
//             a row of A, read four at a time)
// Each thread owns TM consecutive rows and TN consecutive columns of B, read
// as 16-byte vectors where TN allows.
//
// The additive bias is read in place through its own strides (0 on an axis
// it broadcasts over): nothing of size [Lq, Lk] is ever made in device
// memory. Keys past Lk score -inf, so they weigh exactly 0; masked keys carry
// the bias's own -1e9.

#pragma once

#include "tile_logits.cuh"

namespace care_flash {

using care::from_f32;
using care::round_as;
using care::to_f32;

// the running maximum starts here (the NEG_INF of the TPU kernel), not at
// -inf: a row whose keys all carry the -1e9 mask then gets the weights the
// dense softmax gives it
constexpr float MASKED = -1e9f;
constexpr int PAD = 4;

struct BiasRef {
  const float* p;           // null: no bias
  long long sb, sh, sq, sk; // strides in elements over (batch, head, query, key)
};

__device__ __forceinline__ void load4(const float* p, float (&x)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 lo = __bfloat1622float2(p2[0]);
  const float2 hi = __bfloat1622float2(p2[1]);
  x[0] = lo.x; x[1] = lo.y; x[2] = hi.x; x[3] = hi.y;
}

// N consecutive floats of shared memory, as wide as alignment allows
template <int N>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      x[u] = v.x; x[u + 1] = v.y; x[u + 2] = v.z; x[u + 3] = v.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int u = 0; u < N; u += 2) {
      const float2 v = *reinterpret_cast<const float2*>(p + u);
      x[u] = v.x; x[u + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int u = 0; u < N; ++u) x[u] = p[u];
  }
}

// dst[r][c] (leading dimension LD) = src[row0 + r][c] for r < R, c < DH;
// rows at or past n_rows are zeros. src is [n_rows, DH], contiguous.
template <typename T, int R, int DH, int LD, int THREADS>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, int row0,
                                           int n_rows) {
  constexpr int C4 = DH / 4;
  for (int idx = threadIdx.x; idx < R * C4; idx += THREADS) {
    const int r = idx / C4, c = 4 * (idx % C4);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4(src + (size_t)(row0 + r) * DH + c, x);
    *reinterpret_cast<float4*>(dst + r * LD + c) =
        make_float4(x[0], x[1], x[2], x[3]);
  }
}

// dst[c][r] (leading dimension LD) = src[row0 + r][c]: the same tile,
// transposed. Consecutive threads take consecutive rows, so the stores fall
// on consecutive banks.
template <typename T, int R, int DH, int LD, int THREADS>
__device__ __forceinline__ void stage_transposed(float* dst, const T* src,
                                                 int row0, int n_rows) {
  constexpr int C4 = DH / 4;
  for (int idx = threadIdx.x; idx < R * C4; idx += THREADS) {
    const int r = idx % R, c = 4 * (idx / R);
    float x[4] = {0.f, 0.f, 0.f, 0.f};
    if (row0 + r < n_rows) load4(src + (size_t)(row0 + r) * DH + c, x);
#pragma unroll
    for (int u = 0; u < 4; ++u) dst[(c + u) * LD + r] = x[u];
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
}

// acc[i][j] += sum_k A[i * LDA + k] * B[k * LDB + j], k < DEPTH. A points at
// the thread's first row, B at its first column.
template <int TM, int TN, int DEPTH, int LDA, int LDB>
__device__ __forceinline__ void mac_rows(float (&acc)[TM][TN], const float* A,
                                         const float* B) {
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 4) {
    float a[TM][4];
#pragma unroll
    for (int i = 0; i < TM; ++i) load_vec<4>(A + i * LDA + k, a[i]);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float w[TN];
      load_vec<TN>(B + (k + u) * LDB, w);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i][u], w[j], acc[i][j]);
    }
  }
}

// Raw products q.k -> scores: times scale, plus the bias; a key at or past
// Lk scores -inf. The thread holds rows row0.. and keys key0.. of the problem.
// A row past Lq reads the last row's bias and is never stored by the caller.
template <int TM, int TN>
__device__ __forceinline__ void finish_scores(float (&s)[TM][TN], float scale,
                                              const BiasRef& bias, int b, int h,
                                              int row0, int key0, int Lq,
                                              int Lk) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = min(row0 + i, Lq - 1);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int key = key0 + j;
      float x = -INFINITY;
      if (key < Lk) {
        x = s[i][j] * scale;
        if (bias.p)
          x += bias.p[b * bias.sb + h * bias.sh + row * bias.sq +
                      key * bias.sk];
      }
      s[i][j] = x;
    }
  }
}

// The tile shape of the forward kernel's large-query variant: 256 threads as
// 16 x 16, each owning 4 query rows x 4 keys of a 64 x 64 score tile and 4
// rows x DH/16 columns of an output tile.
constexpr int BQ = 64, BKV = 64, TX = 16, TM = 4;

}  // namespace care_flash
