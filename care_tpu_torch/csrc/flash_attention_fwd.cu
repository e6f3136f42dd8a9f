// Flash attention, forward: softmax(q k^T / sqrt(Dh) + bias) v by key tiles
// with an online softmax, so that the [Lq, Lk] scores never reach device
// memory; also the per-row log-sum-exp that the backward kernels recompute
// the probabilities from.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// care_tpu/ops/pallas/flash_attention.py (launched by `_flash_fwd_impl`). For
// q [B, H, Lq, Dh], k and v [B, H, Lk, Dh] (f32 or bf16, contiguous) and an
// optional f32 bias read through its strides over (B, H, Lq, Lk):
//   s   = (q k^T) * Dh^-0.5 + bias           accumulated in f32
//   out = softmax(s) v   [B, H, Lq, Dh], in q's type;   lse [B, H, Lq] f32
// The rules that are part of the function: the running maximum starts at
// -1e9, not -inf; the probabilities are rounded to the input type before the
// second product, which accumulates in f32, while their sum is taken
// unrounded; a row whose sum is 0 gives output 0 and lse 1e9.
//
// What bounds it on an H100 SXM (3.35 TB/s, 67 TFLOP/s f32 on the CUDA
// cores), f32:
//   decode shape, q [64, 8, 5, 64] against 1654 keys (one launch per decoder
//     layer per beam step of the long-key configuration): K and V are read
//     once, 433.6 MB, 0.129 ms, against 2.17 GFLOP, 0.032 ms: bytes;
//   square shape [4, 8, 1568, 64]: 20.1 GFLOP, 0.301 ms, against 51 MB,
//     0.015 ms: operations.
//
// Design. The TPU kernel carries (max, sum, accumulator) in scratch memory
// across a sequential grid axis over the key blocks. Blocks on the card run
// in no order, so that axis is a loop inside the block: one block owns a
// (batch * head, query tile) pair, keeps Q in shared memory, and walks the
// key tiles; for each it stages K (transposed) and V, forms the score tile,
// updates the rows' maxima and sums in shared memory, and adds P V into
// accumulators in registers that it rescales as the maximum moves. Every
// output element has one owner and every sum a fixed order, so a call
// repeats bit for bit. Two tile shapes:
//   large queries: 64 query rows x 64 keys, 256 threads, 4 x 4 scores and
//     4 x Dh/16 outputs per thread;
//   at most 8 query rows (the beam-grouped decode step): 8 rows x 64 keys,
//     128 threads, so that the 3/8 of padding rows cost little and several
//     blocks share an SM to hide the loads of K and V, which is all the
//     work there is.
// Ragged edges are bounds checks: rows past Lq are computed on zeros and not
// stored, keys past Lk score -inf. Making it fast (cp.async or TMA pipelines,
// wgmma in a working type, splitting the keys over blocks at small batch) is
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), or -1 for a
// head width it has no instance for.

#include "flash_tile.cuh"

namespace {

using namespace care_flash;

template <int DH, int BQ_, int BKV_, int TX_, int TM_>
struct Cfg {
  static constexpr int TY_ = BQ_ / TM_, THREADS_ = TX_ * TY_;
  static constexpr int TN_S_ = BKV_ / TX_, TN_O = DH / TX_;
  static constexpr int LDQ = DH + PAD, LDK = BKV_ + PAD, LDV = DH,
                       LDS = BKV_ + PAD;
  static constexpr int TPR = THREADS_ / BQ_;   // threads per row, softmax pass
  static constexpr int FLOATS =
      BQ_ * LDQ + DH * LDK + BKV_ * LDV + BQ_ * LDS + 3 * BQ_;
  static_assert(TN_S_ >= 1 && TN_O >= 1 && TPR >= 1 && TPR <= 32 &&
                (TPR & (TPR - 1)) == 0, "tile shape");
};

template <typename T, int DH, int BQ_, int BKV_, int TX_, int TM_>
__global__ void __launch_bounds__(TX_ * (BQ_ / TM_))
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, BiasRef bias, int H, int Lq, int Lk,
                 float scale, T* __restrict__ out, float* __restrict__ lse) {
  using C = Cfg<DH, BQ_, BKV_, TX_, TM_>;
  constexpr int NT = C::THREADS_, TN_O = C::TN_O, TN_S_ = C::TN_S_;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                       // [BQ][LDQ]
  float* Kt = Qs + BQ_ * C::LDQ;          // [DH][LDK], K transposed
  float* Vs = Kt + DH * C::LDK;           // [BKV][LDV]
  float* Ps = Vs + BKV_ * C::LDV;         // [BQ][LDS], scores then weights
  float* m_s = Ps + BQ_ * C::LDS;         // [BQ] running maximum
  float* l_s = m_s + BQ_;                 // [BQ] running sum
  float* alpha_s = l_s + BQ_;             // [BQ] this tile's rescale

  const int tid = threadIdx.x, tx = tid % TX_, ty = tid / TX_;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ_;
  const int b = bh / H, h = bh % H;
  const T* kb = k + (size_t)bh * Lk * DH;
  const T* vb = v + (size_t)bh * Lk * DH;

  stage_rows<T, BQ_, DH, C::LDQ, NT>(Qs, q + (size_t)bh * Lq * DH, q0, Lq);
  if (tid < BQ_) { m_s[tid] = MASKED; l_s[tid] = 0.f; }
  float acc[TM_][TN_O];
  zero(acc);

  for (int k0 = 0; k0 < Lk; k0 += BKV_) {
    stage_transposed<T, BKV_, DH, C::LDK, NT>(Kt, kb, k0, Lk);
    stage_rows<T, BKV_, DH, C::LDV, NT>(Vs, vb, k0, Lk);
    __syncthreads();

    {
      float s[TM_][TN_S_];
      zero(s);
      mac_rows<TM_, TN_S_, DH, C::LDQ, C::LDK>(s, Qs + ty * TM_ * C::LDQ,
                                               Kt + tx * TN_S_);
      finish_scores(s, scale, bias, b, h, q0 + ty * TM_, k0 + tx * TN_S_, Lq,
                    Lk);
#pragma unroll
      for (int i = 0; i < TM_; ++i)
#pragma unroll
        for (int j = 0; j < TN_S_; ++j)
          Ps[(ty * TM_ + i) * C::LDS + tx * TN_S_ + j] = s[i][j];
    }
    __syncthreads();

    {
      // TPR neighbouring lanes share a row: its maximum, weights and sum
      const int r = tid / C::TPR, sub = tid % C::TPR;
      float* row = Ps + r * C::LDS;
      float mx = -INFINITY;
      for (int c = sub; c < BKV_; c += C::TPR) mx = fmaxf(mx, row[c]);
#pragma unroll
      for (int o = C::TPR / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = sub; c < BKV_; c += C::TPR) {
        const float p = expf(row[c] - m_new);
        sum += p;
        row[c] = round_as(p, static_cast<const T*>(nullptr));
      }
#pragma unroll
      for (int o = C::TPR / 2; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (sub == 0) {
        const float alpha = expf(m_prev - m_new);
        alpha_s[r] = alpha;
        l_s[r] = alpha * l_s[r] + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < TM_; ++i) {
      const float alpha = alpha_s[ty * TM_ + i];
#pragma unroll
      for (int j = 0; j < TN_O; ++j) acc[i][j] *= alpha;
    }
    mac_rows<TM_, TN_O, BKV_, C::LDS, C::LDV>(acc, Ps + ty * TM_ * C::LDS,
                                              Vs + tx * TN_O);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM_; ++i) {
    const int row = ty * TM_ + i;
    if (q0 + row >= Lq) continue;
    const float l = l_s[row];
    const float safe = l == 0.f ? 1.f : l;
    T* o = out + ((size_t)bh * Lq + q0 + row) * DH + tx * TN_O;
#pragma unroll
    for (int j = 0; j < TN_O; ++j) from_f32(acc[i][j] / safe, o + j);
  }
  if (tid < BQ_ && q0 + tid < Lq) {
    const float l = l_s[tid];
    lse[(size_t)bh * Lq + q0 + tid] = l == 0.f ? 1e9f : m_s[tid] + logf(l);
  }
}

template <typename T, int DH, int BQ_, int BKV_, int TX_, int TM_>
int launch_as(const void* q, const void* k, const void* v, BiasRef bias, int B,
              int H, int Lq, int Lk, void* out, void* lse, cudaStream_t st) {
  using C = Cfg<DH, BQ_, BKV_, TX_, TM_>;
  auto kernel = flash_fwd_kernel<T, DH, BQ_, BKV_, TX_, TM_>;
  constexpr int bytes = C::FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lq + BQ_ - 1) / BQ_);
  kernel<<<grid, C::THREADS_, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, H, Lq, Lk, 1.0f / sqrtf((float)DH),
      static_cast<T*>(out), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// at most this many query rows take the small-query tile
constexpr int SMALL_Q = 8;

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias, int B,
              int H, int Lq, int Lk, void* out, void* lse, cudaStream_t st) {
  if (Lq > SMALL_Q)
    return launch_as<T, DH, BQ, BKV, TX, TM>(q, k, v, bias, B, H, Lq, Lk, out,
                                             lse, st);
  // 128 threads: the keys (and the output columns) spread over the lanes
  constexpr int SX = DH >= 64 ? 64 : 32;
  constexpr int STM = DH >= 64 ? 4 : 2;
  return launch_as<T, DH, SMALL_Q, SX, SX, STM>(q, k, v, bias, B, H, Lq, Lk,
                                                out, lse, st);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long sb, long long sh, long long sq, long long sk, int B, int H,
           int Lq, int Lk, int Dh, void* out, void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasRef ref{static_cast<const float*>(bias), sb, sh, sq, sk};
  switch (Dh) {
    case 32: return launch_dh<T, 32>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    case 64: return launch_dh<T, 64>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    case 128:
      return launch_dh<T, 128>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q [B, H, Lq, Dh], k, v [B, H, Lk, Dh] float32, contiguous; bias float32 or
// null, with its strides in elements over (B, H, Lq, Lk), 0 where it
// broadcasts; outputs out [B, H, Lq, Dh] float32 and lse [B, H, Lq] float32.
int care_flash_fwd_f32(const void* q, const void* k, const void* v,
                       const void* bias, long long sb, long long sh,
                       long long sq, long long sk, int B, int H, int Lq, int Lk,
                       int Dh, void* out, void* lse, void* stream) {
  return launch<float>(q, k, v, bias, sb, sh, sq, sk, B, H, Lq, Lk, Dh, out,
                       lse, stream);
}

// the same with q, k, v and out in bfloat16
int care_flash_fwd_bf16(const void* q, const void* k, const void* v,
                        const void* bias, long long sb, long long sh,
                        long long sq, long long sk, int B, int H, int Lq,
                        int Lk, int Dh, void* out, void* lse, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, sb, sh, sq, sk, B, H, Lq, Lk, Dh,
                               out, lse, stream);
}

}  // extern "C"
