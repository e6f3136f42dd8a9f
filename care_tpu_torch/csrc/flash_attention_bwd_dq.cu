// Flash attention, backward with respect to the queries: dq, with the
// probabilities recomputed tile by tile from the forward's log-sum-exp.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` of
// care_tpu/ops/pallas/flash_attention.py (launched by `_flash_bwd_rule`). For
// q, do [B, H, Lq, Dh], k, v [B, H, Lk, Dh] (f32 or bf16, contiguous), an
// optional f32 bias without a query extent, read through its strides over
// (B, H, Lk), the forward's lse [B, H, Lq] and delta = sum_d do * out
// [B, H, Lq] (both f32):
//   s  = (q k^T) * Dh^-0.5 + bias
//   p  = exp(s - lse)                       (never stored)
//   g  = p * (do v^T - delta)               rounded to the input type
//   dq = (g k) * Dh^-0.5                    [B, H, Lq, Dh], in q's type
// All three products accumulate in f32.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 on the CUDA cores,
// 3.35 TB/s): at the square shape [4, 8, 1568, 64], f32, three products of
// 2 * 32 * 1568^2 * 64 flop each = 30.2 GFLOP, 0.451 ms, against 64 MB
// (q, k, v, do, dq and the row vectors), 0.019 ms: operations. No model path
// reaches it; it is the backward of `flash_attention(backward="kernel")`.
//
// Design. The TPU kernel accumulates dq in scratch memory across a
// sequential grid axis over the key blocks; here one block owns a
// (batch * head, 64-row query tile) pair and loops over 64-key tiles. Q and
// dO stay in shared memory for the whole loop; each key tile is staged three
// ways (K and V transposed for the two score-shaped products, K by rows for
// g k). A thread holds its 4 x 4 corner of s, then of do v^T, in registers,
// turns them into g, and only g passes through shared memory. dq has one
// owner per element and a fixed summation order: no atomics, and a call
// repeats bit for bit. wgmma in a working type is later work.
//
// Build and interface: as flash_attention_fwd.cu.

#include "flash_tile.cuh"

namespace {

using namespace care_flash;

template <int DH>
struct Cfg {
  static constexpr int TN_O = DH / TX;
  static constexpr int LDQ = DH + PAD, LDK = BKV + PAD, LDG = BKV + PAD;
  static constexpr int FLOATS =
      2 * BQ * LDQ + 2 * DH * LDK + BKV * DH + BQ * LDG + 2 * BQ;
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, BiasRef bias,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    const float* __restrict__ delta, int H, int Lq, int Lk,
                    float scale, T* __restrict__ dq) {
  using C = Cfg<DH>;
  constexpr int TN_O = C::TN_O;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LDQ]
  float* dOs = Qs + BQ * C::LDQ;          // [BQ][LDQ]
  float* Kt = dOs + BQ * C::LDQ;          // [DH][LDK], K transposed
  float* Vt = Kt + DH * C::LDK;           // [DH][LDK], V transposed
  float* Ks = Vt + DH * C::LDK;           // [BKV][DH]
  float* Gs = Ks + BKV * DH;              // [BQ][LDG]
  float* lse_s = Gs + BQ * C::LDG;        // [BQ]
  float* delta_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const T* kb = k + (size_t)bh * Lk * DH;
  const T* vb = v + (size_t)bh * Lk * DH;

  stage_rows<T, BQ, DH, C::LDQ, THREADS>(Qs, q + (size_t)bh * Lq * DH, q0, Lq);
  stage_rows<T, BQ, DH, C::LDQ, THREADS>(dOs, dout + (size_t)bh * Lq * DH, q0,
                                         Lq);
  if (tid < BQ) {
    const bool live = q0 + tid < Lq;
    lse_s[tid] = live ? lse[(size_t)bh * Lq + q0 + tid] : 0.f;
    delta_s[tid] = live ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
  }
  float acc[TM][TN_O];
  zero(acc);

  for (int k0 = 0; k0 < Lk; k0 += BKV) {
    stage_transposed<T, BKV, DH, C::LDK, THREADS>(Kt, kb, k0, Lk);
    stage_transposed<T, BKV, DH, C::LDK, THREADS>(Vt, vb, k0, Lk);
    stage_rows<T, BKV, DH, DH, THREADS>(Ks, kb, k0, Lk);
    __syncthreads();

    float s[TM][TN_S], dp[TM][TN_S];
    zero(s);
    mac_rows<TM, TN_S, DH, C::LDQ, C::LDK>(s, Qs + ty * TM * C::LDQ,
                                           Kt + tx * TN_S);
    finish_scores(s, scale, bias, b, h, q0 + ty * TM, k0 + tx * TN_S, Lq, Lk);
    zero(dp);
    mac_rows<TM, TN_S, DH, C::LDQ, C::LDK>(dp, dOs + ty * TM * C::LDQ,
                                           Vt + tx * TN_S);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int row = ty * TM + i;
      const float row_lse = lse_s[row], row_delta = delta_s[row];
#pragma unroll
      for (int j = 0; j < TN_S; ++j) {
        // a key past Lk scored -inf: p = 0
        const float g = expf(s[i][j] - row_lse) * (dp[i][j] - row_delta);
        Gs[row * C::LDG + tx * TN_S + j] =
            round_as(g, static_cast<const T*>(nullptr));
      }
    }
    __syncthreads();

    mac_rows<TM, TN_O, BKV, C::LDG, DH>(acc, Gs + ty * TM * C::LDG,
                                        Ks + tx * TN_O);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = q0 + ty * TM + i;
    if (row >= Lq) continue;
    T* o = dq + ((size_t)bh * Lq + row) * DH + tx * TN_O;
#pragma unroll
    for (int j = 0; j < TN_O; ++j) from_f32(acc[i][j] * scale, o + j);
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias,
              const void* lse, const void* dout, const void* delta, int B,
              int H, int Lq, int Lk, void* dq, cudaStream_t st) {
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  constexpr int bytes = Cfg<DH>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lq + BQ - 1) / BQ);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta), H, Lq, Lk,
      1.0f / sqrtf((float)DH), static_cast<T*>(dq));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long sb, long long sh, long long sk, const void* lse,
           const void* dout, const void* delta, int B, int H, int Lq, int Lk,
           int Dh, void* dq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasRef ref{static_cast<const float*>(bias), sb, sh, 0, sk};
  switch (Dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk, dq,
                              st);
    case 64:
      return launch_dh<T, 64>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk, dq,
                              st);
    case 128:
      return launch_dh<T, 128>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk,
                               dq, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, dout [B, H, Lq, Dh], k, v [B, H, Lk, Dh] float32, contiguous; bias
// float32 or null with its strides in elements over (B, H, Lk), 0 where it
// broadcasts; lse, delta [B, H, Lq] float32; output dq [B, H, Lq, Dh] float32.
int care_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                          const void* bias, long long sb, long long sh,
                          long long sk, const void* lse, const void* dout,
                          const void* delta, int B, int H, int Lq, int Lk,
                          int Dh, void* dq, void* stream) {
  return launch<float>(q, k, v, bias, sb, sh, sk, lse, dout, delta, B, H, Lq,
                       Lk, Dh, dq, stream);
}

// the same with q, k, v, dout and dq in bfloat16
int care_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                           const void* bias, long long sb, long long sh,
                           long long sk, const void* lse, const void* dout,
                           const void* delta, int B, int H, int Lq, int Lk,
                           int Dh, void* dq, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, sb, sh, sk, lse, dout, delta, B,
                               H, Lq, Lk, Dh, dq, stream);
}

}  // extern "C"
