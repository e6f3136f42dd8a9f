// Flash attention, backward with respect to the keys, the values and the
// bias: dk, dv and the bias gradient per (batch, head), with the probabilities
// recomputed tile by tile from the forward's log-sum-exp.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` of
// care_tpu/ops/pallas/flash_attention.py (launched by `_flash_bwd_rule`).
// Operands as flash_attention_bwd_dq.cu:
//   s  = (q k^T) * Dh^-0.5 + bias,   p = exp(s - lse)        (never stored)
//   dv = p^T do                       p rounded to the input type
//   g  = p * (do v^T - delta)
//   dk = (g^T q) * Dh^-0.5            g rounded to the input type
//   dbias[b, h, key] = sum over the query rows of g   (unrounded, f32)
// dk, dv are [B, H, Lk, Dh] in k's type, dbias [B, H, Lk] f32; the caller
// sums dbias down to the bias's own shape. All products accumulate in f32.
//
// What bounds it on an H100 SXM (67 TFLOP/s f32 on the CUDA cores,
// 3.35 TB/s): at the square shape [4, 8, 1568, 64], f32, four products of
// 2 * 32 * 1568^2 * 64 flop each = 40.3 GFLOP, 0.601 ms, against 77 MB,
// 0.023 ms: operations. No model path reaches it; it is the backward of
// `flash_attention(backward="kernel")`.
//
// Design. The TPU kernel accumulates (dk, dv, dbias) in scratch memory
// across a sequential grid axis over the query blocks; here one block owns a
// (batch * head, 64-key tile) pair, keeps K and V (transposed) in shared
// memory, and loops over 64-row query tiles. For each it stages Q and dO,
// forms its 4 x 4 corners of s and do v^T in registers, and writes p and g to
// shared memory; then every thread, now owning 4 keys x Dh/16 columns, adds
// p^T do and g^T q into its dv and dk accumulators, and 64 threads add g's
// column sums into dbias. Query rows past Lq and keys past Lk get p = 0.
// Every output element has one owner and every sum a fixed order: no
// atomics, and a call repeats bit for bit. wgmma in a working type is later
// work.
//
// Build and interface: as flash_attention_fwd.cu.

#include "flash_tile.cuh"

namespace {

using namespace care_flash;

static_assert(BQ == BKV, "a thread keeps its (ty, tx) place in both phases");

template <int DH>
struct Cfg {
  static constexpr int TN_O = DH / TX;
  static constexpr int LDQ = DH + PAD, LDK = BKV + PAD, LDS = BKV + PAD;
  static constexpr int FLOATS =
      2 * BQ * LDQ + 2 * DH * LDK + 2 * BQ * LDS + 2 * BQ;
};

template <typename T, int DH>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, BiasRef bias,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     const float* __restrict__ delta, int H, int Lq, int Lk,
                     float scale, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias) {
  using C = Cfg<DH>;
  constexpr int TN_O = C::TN_O;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LDQ]
  float* dOs = Qs + BQ * C::LDQ;          // [BQ][LDQ]
  float* Kt = dOs + BQ * C::LDQ;          // [DH][LDK], K transposed
  float* Vt = Kt + DH * C::LDK;           // [DH][LDK], V transposed
  float* Ps = Vt + DH * C::LDK;           // [BQ][LDS]
  float* Gs = Ps + BQ * C::LDS;           // [BQ][LDS], unrounded
  float* lse_s = Gs + BQ * C::LDS;        // [BQ]
  float* delta_s = lse_s + BQ;            // [BQ]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int bh = blockIdx.x, k0 = blockIdx.y * BKV;
  const int b = bh / H, h = bh % H;
  const T* qb = q + (size_t)bh * Lq * DH;
  const T* dob = dout + (size_t)bh * Lq * DH;

  stage_transposed<T, BKV, DH, C::LDK, THREADS>(
      Kt, k + (size_t)bh * Lk * DH, k0, Lk);
  stage_transposed<T, BKV, DH, C::LDK, THREADS>(
      Vt, v + (size_t)bh * Lk * DH, k0, Lk);
  float acc_k[TM][TN_O], acc_v[TM][TN_O];
  zero(acc_k);
  zero(acc_v);
  float db = 0.f;

  for (int q0 = 0; q0 < Lq; q0 += BQ) {
    stage_rows<T, BQ, DH, C::LDQ, THREADS>(Qs, qb, q0, Lq);
    stage_rows<T, BQ, DH, C::LDQ, THREADS>(dOs, dob, q0, Lq);
    if (tid < BQ) {
      const bool live = q0 + tid < Lq;
      lse_s[tid] = live ? lse[(size_t)bh * Lq + q0 + tid] : 0.f;
      delta_s[tid] = live ? delta[(size_t)bh * Lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    {
      float s[TM][TN_S], dp[TM][TN_S];
      zero(s);
      mac_rows<TM, TN_S, DH, C::LDQ, C::LDK>(s, Qs + ty * TM * C::LDQ,
                                             Kt + tx * TN_S);
      finish_scores(s, scale, bias, b, h, q0 + ty * TM, k0 + tx * TN_S, Lq,
                    Lk);
      zero(dp);
      mac_rows<TM, TN_S, DH, C::LDQ, C::LDK>(dp, dOs + ty * TM * C::LDQ,
                                             Vt + tx * TN_S);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int row = ty * TM + i;
        const bool live = q0 + row < Lq;
        const float row_lse = lse_s[row], row_delta = delta_s[row];
#pragma unroll
        for (int j = 0; j < TN_S; ++j) {
          // a key past Lk scored -inf: p = 0
          const float p = live ? expf(s[i][j] - row_lse) : 0.f;
          Ps[row * C::LDS + tx * TN_S + j] =
              round_as(p, static_cast<const T*>(nullptr));
          Gs[row * C::LDS + tx * TN_S + j] = p * (dp[i][j] - row_delta);
        }
      }
    }
    __syncthreads();

    // now the thread owns keys ty * TM.. and columns tx * TN_O..
    mac_cols<float, TM, TN_O, BQ, C::LDS, C::LDQ>(acc_v, Ps + ty * TM,
                                                  dOs + tx * TN_O);
    mac_cols<T, TM, TN_O, BQ, C::LDS, C::LDQ>(acc_k, Gs + ty * TM,
                                              Qs + tx * TN_O);
    if (dbias != nullptr && tid < BKV) {
      for (int r = 0; r < BQ; ++r) db += Gs[r * C::LDS + tid];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int key = k0 + ty * TM + i;
    if (key >= Lk) continue;
    const size_t at = ((size_t)bh * Lk + key) * DH + tx * TN_O;
#pragma unroll
    for (int j = 0; j < TN_O; ++j) {
      from_f32(acc_k[i][j] * scale, dk + at + j);
      from_f32(acc_v[i][j], dv + at + j);
    }
  }
  if (dbias != nullptr && tid < BKV && k0 + tid < Lk)
    dbias[(size_t)bh * Lk + k0 + tid] = db;
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias,
              const void* lse, const void* dout, const void* delta, int B,
              int H, int Lq, int Lk, void* dk, void* dv, void* dbias,
              cudaStream_t st) {
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  constexpr int bytes = Cfg<DH>::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lk + BKV - 1) / BKV);
  kernel<<<grid, THREADS, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, static_cast<const float*>(lse),
      static_cast<const T*>(dout), static_cast<const float*>(delta), H, Lq, Lk,
      1.0f / sqrtf((float)DH), static_cast<T*>(dk), static_cast<T*>(dv),
      static_cast<float*>(dbias));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long sb, long long sh, long long sk, const void* lse,
           const void* dout, const void* delta, int B, int H, int Lq, int Lk,
           int Dh, void* dk, void* dv, void* dbias, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasRef ref{static_cast<const float*>(bias), sb, sh, 0, sk};
  switch (Dh) {
    case 32:
      return launch_dh<T, 32>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk, dk,
                              dv, dbias, st);
    case 64:
      return launch_dh<T, 64>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk, dk,
                              dv, dbias, st);
    case 128:
      return launch_dh<T, 128>(q, k, v, ref, lse, dout, delta, B, H, Lq, Lk,
                               dk, dv, dbias, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q, dout [B, H, Lq, Dh], k, v [B, H, Lk, Dh] float32, contiguous; bias
// float32 or null with its strides in elements over (B, H, Lk), 0 where it
// broadcasts; lse, delta [B, H, Lq] float32; outputs dk, dv [B, H, Lk, Dh]
// float32 and dbias [B, H, Lk] float32 (null: not wanted).
int care_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                           const void* bias, long long sb, long long sh,
                           long long sk, const void* lse, const void* dout,
                           const void* delta, int B, int H, int Lq, int Lk,
                           int Dh, void* dk, void* dv, void* dbias,
                           void* stream) {
  return launch<float>(q, k, v, bias, sb, sh, sk, lse, dout, delta, B, H, Lq,
                       Lk, Dh, dk, dv, dbias, stream);
}

// the same with q, k, v, dout, dk and dv in bfloat16
int care_flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                            const void* bias, long long sb, long long sh,
                            long long sk, const void* lse, const void* dout,
                            const void* delta, int B, int H, int Lq, int Lk,
                            int Dh, void* dk, void* dv, void* dbias,
                            void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, sb, sh, sk, lse, dout, delta, B,
                               H, Lq, Lk, Dh, dk, dv, dbias, stream);
}

}  // extern "C"
