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
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 and 989 bf16
// on the tensor cores): three products of 2 * B * H * Lq * Lk * Dh flop, 6
// B H Lq Lk Dh in all. An f32 product as accurate as f32 takes three TF32
// products (3xTF32, tile_logits_tc.cuh), so at the square shape
// [4, 8, 1568, 64] f32: 30.2 GFLOP x 3 at 495 TFLOP/s = 0.183 ms, against
// 64 MB (q, k, v, do, dq and the row vectors), 0.019 ms: operations. No
// model path reaches it; it is the backward of
// `flash_attention(backward="kernel")`.
//
// Design. The TPU kernel accumulates dq in scratch memory across a
// sequential grid axis over the key blocks; here one block owns a
// (batch * head, query tile) pair and loops over key tiles, every product
// on the tensor cores through mma.sync (m16n8k8 TF32 three times for f32,
// m16n8k16 bf16 once; tile_logits_tc.cuh says why not wgmma). Each of the
// four warps owns 16 query rows. Q and dO stay in shared memory for the
// whole loop, read as A fragments through ldmatrix (f32: split per warp as
// read, since each warp reads only its rows). Key tiles (K, V and the
// bias's key row) stream through a cp.async ring, so the loads of tile t+1
// overlap the products of tile t; an f32 tile is split once into TF32 hi/lo
// planes after it lands, since all four warps read all of it. s and
// do v^T live in mma accumulators; g is formed in them; g then becomes the
// A operand of g k straight from the registers (tile_logits_tc.cuh:
// acc_to_a, with the TF32 depth permuted and K read down its columns at
// the matching rows), each tile's products from zero and added to dq in
// f32. Per warp and 32-key tile (f32, Dh 64) that is 288 mma against about
// 700 other instructions and about 540 cycles of shared-memory traffic.
// Measured on an H100 (kernel_probe), the kernel is bound by that feeding
// work, not by the tensor cores: without its mma instructions it takes as
// long; at the square shape it reaches 41% of the mma.sync TF32 rate
// (about 310 TFLOP/s), which is itself below the data-sheet peak that only
// wgmma reaches. The tile sizes are the fastest of those kernel_probe-style
// experiments tried (2 or 3 stages, 16 or 32 keys, 4 or 8 warps).
//
// Ragged edges are bounds checks: keys past Lk get a bias of -inf (p = 0),
// query rows past Lq read zeros and an lse of +inf and are not stored. dq
// has one owner per element and a fixed summation order: no atomics, and a
// call repeats bit for bit.
//
// Build and interface: as flash_attention_fwd.cu.

#include "flash_tile.cuh"
#include "tile_logits_tc.cuh"

namespace {

using namespace care_flash;
namespace tc = care::tc;

template <typename T, int DH>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WARPS = 4, BQ = 16 * WARPS, NT = 32 * WARPS;
  // keys per tile: f32 32 (its hi/lo planes and registers), bf16 64
  static constexpr int BKV = F32 ? 32 : 64;
  // ring depth: 3, or 2 where a third stage would cost an SM's second block
  static constexpr int STAGES = DH == 128 ? 2 : 3;
  static constexpr int LD = DH + 16 / (int)sizeof(T);   // pitch, elements
  static constexpr int TILE = BKV * LD;                 // one K or V tile
  static constexpr size_t BYTES =
      sizeof(T) * (2 * BQ * LD + STAGES * 2 * TILE) +
      sizeof(float) * (STAGES * BKV + (F32 ? 2 * TILE : 0) + 2 * BQ);
};

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, BiasRef bias,
                    const float* __restrict__ lse, const T* __restrict__ dout,
                    const float* __restrict__ delta, int H, int Lq, int Lk,
                    float scale, T* __restrict__ dq) {
  using C = Cfg<T, DH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NT = C::NT;
  constexpr int NF = BKV / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);                 // [BQ][LD]
  T* dOs = Qs + BQ * LD;                                  // [BQ][LD]
  T* ring = dOs + BQ * LD;              // STAGES x (K [BKV][LD], V [BKV][LD])
  float* bias_ring = reinterpret_cast<float*>(ring + C::STAGES * 2 * C::TILE);
  float* lo = bias_ring + C::STAGES * BKV;   // f32: K lo, V lo [BKV][LD]
  float* lse_s = lo + (C::F32 ? 2 * C::TILE : 0);         // [BQ]
  float* delta_s = lse_s + BQ;                            // [BQ]

  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 16;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const T* kb = k + (size_t)bh * Lk * DH;
  const T* vb = v + (size_t)bh * Lk * DH;
  const int n_tiles = (Lk + BKV - 1) / BKV;

  tc::stage_rows(Qs, LD, q + (size_t)bh * Lq * DH, DH, q0, Lq, BQ, 0, DH, DH,
                 tid, NT);
  tc::stage_rows(dOs, LD, dout + (size_t)bh * Lq * DH, DH, q0, Lq, BQ, 0, DH,
                 DH, tid, NT);
  for (int r = tid; r < BQ; r += NT) {
    const bool live = q0 + r < Lq;
    lse_s[r] = live ? lse[(size_t)bh * Lq + q0 + r] : INFINITY;
    delta_s[r] = live ? delta[(size_t)bh * Lq + q0 + r] : 0.f;
  }

  // key tile t into ring slot t % STAGES (one commit group, empty past the
  // last tile)
  auto load = [&](int t) {
    if (t < n_tiles) {
      const int slot = t % C::STAGES, k0 = t * BKV;
      T* dst = ring + slot * 2 * C::TILE;
      tc::stage_rows(dst, LD, kb, DH, k0, Lk, BKV, 0, DH, DH, tid, NT);
      tc::stage_rows(dst + C::TILE, LD, vb, DH, k0, Lk, BKV, 0, DH, DH, tid,
                     NT);
      for (int i = tid; i < BKV; i += NT) {
        float* d = bias_ring + slot * BKV + i;
        const int key = k0 + i;
        if (key >= Lk)
          *d = -INFINITY;
        else if (bias.p)
          tc::cp_async4(d, bias.p + b * bias.sb + h * bias.sh + key * bias.sk,
                        4);
        else
          *d = 0.f;
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) load(s);

  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  const int g = lane >> 2, qd = lane & 3;
  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait(C::STAGES - 2);
    __syncthreads();   // tile t visible; every warp done with tile t - 1
    load(t + C::STAGES - 1);
    const int slot = t % C::STAGES;
    T* Kt = ring + slot * 2 * C::TILE;
    T* Vt = Kt + C::TILE;
    tc::Planes<T> Kp, Vp;
    if constexpr (C::F32) {
      tc::split_in_place<BKV, DH, LD, NT>(Kt, lo, tid);
      tc::split_in_place<BKV, DH, LD, NT>(Vt, lo + C::TILE, tid);
      __syncthreads();
      Kp = {Kt, lo, LD};
      Vp = {Vt, lo + C::TILE, LD};
    } else {
      Kp = {Kt, LD};
      Vp = {Vt, LD};
    }

    float s[NF][4], dp[NF][4];
    tc::score_pair<T, NF, DH>(s, dp, Qs, dOs, LD, m0, Kp, Vp, lane);
    // g = p * (dp - delta) into s; fragment element e is row g + 8 (e / 2),
    // key 8j + 2qd + e % 2
    const float* brow = bias_ring + slot * BKV;
    const float row_lse[2] = {lse_s[m0 + g], lse_s[m0 + g + 8]};
    const float row_delta[2] = {delta_s[m0 + g], delta_s[m0 + g + 8]};
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float x = s[j][e] * scale + brow[8 * j + 2 * qd + (e & 1)];
        s[j][e] = expf(x - row_lse[e >> 1]) * (dp[j][e] - row_delta[e >> 1]);
      }
    tc::acc_product<T, NF, NO>(acc, s, Kp, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = q0 + m0 + g + 8 * half;
    if (row >= Lq) continue;
    T* o = dq + ((size_t)bh * Lq + row) * DH + 2 * qd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      from_f32(acc[j][2 * half] * scale, o + 8 * j);
      from_f32(acc[j][2 * half + 1] * scale, o + 8 * j + 1);
    }
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias,
              const void* lse, const void* dout, const void* delta, int B,
              int H, int Lq, int Lk, void* dq, cudaStream_t st) {
  using C = Cfg<T, DH>;
  auto kernel = flash_bwd_dq_kernel<T, DH>;
  constexpr int bytes = static_cast<int>(C::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, bytes, st>>>(
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
