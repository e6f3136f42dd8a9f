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
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32 and 989 bf16
// on the tensor cores): four products of 2 * B * H * Lq * Lk * Dh flop, 8
// B H Lq Lk Dh in all; f32 at f32 accuracy takes three TF32 products each
// (3xTF32). At the square shape [4, 8, 1568, 64] f32: 40.3 GFLOP x 3 at
// 495 TFLOP/s = 0.244 ms, against 77 MB, 0.023 ms: operations. No model
// path reaches it; it is the backward of `flash_attention(backward="kernel")`.
//
// Design. The TPU kernel accumulates (dk, dv, dbias) in scratch memory
// across a sequential grid axis over the query blocks; here one block owns a
// (batch * head, key tile) pair and loops over query tiles, every product on
// the tensor cores through mma.sync (3xTF32 m16n8k8 for f32, m16n8k16 bf16),
// as flash_attention_bwd_dq.cu with the roles of queries and keys swapped.
// Each of the four warps owns 16 keys. K and V stay in shared memory, read
// as A fragments (f32 split per warp as read); query tiles (Q, dO, and the
// rows' lse and delta) stream through a cp.async ring, and an f32 tile is
// split once into TF32 hi/lo planes after it lands. The warp forms
// s^T = k q^T and dp^T = v do^T with its keys as the accumulator rows, so
// p^T and g^T come out in accumulator layout and are the A operands of
// dv += p^T do and dk += g^T q straight from the registers (do and q read
// down their columns), each tile's products from zero and added in f32.
// dbias[key] is then a row sum inside the thread (its two keys: per tile a
// pairwise tree over its query rows, then one add) and, at the end, over
// the four lanes of a quad by xor shuffles: no shared memory, no atomics.
// The bias is a row of the thread's two keys, read once. As in the dq
// kernel, what bounds it on an H100 is the work that feeds mma.sync, not
// the tensor cores (kernel_probe: 41% of the mma.sync TF32 rate at the
// square shape).
//
// Ragged edges are bounds checks: query rows past Lq read zeros and an lse
// of +inf, so p = g = 0; keys past Lk get a bias of -inf and are not stored.
// Every output element has one owner and every sum a fixed order: no
// atomics, and a call repeats bit for bit.
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
  static constexpr int WARPS = 4, BKV = 16 * WARPS, NT = 32 * WARPS;
  // query rows per tile: what the dk and dv accumulators leave of the
  // registers; bf16 at Dh 32 and 64 takes 128 rows in a 2-stage ring (on
  // an H100 14% faster than 64 rows in 3 stages, with the tree below)
  static constexpr int BQ =
      F32 ? (DH == 128 ? 16 : 32) : (DH == 128 ? 32 : 128);
  static constexpr int STAGES = F32 && DH < 128 ? 3 : 2;
  static constexpr int LD = DH + 16 / (int)sizeof(T);   // pitch, elements
  static constexpr int TILE = BQ * LD;                  // one Q or dO tile
  static constexpr size_t BYTES =
      sizeof(T) * (2 * BKV * LD + STAGES * 2 * TILE) +
      sizeof(float) * (STAGES * 2 * BQ + (F32 ? 2 * TILE : 0));
};

template <typename T, int DH>
__global__ void __launch_bounds__(Cfg<T, DH>::NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, BiasRef bias,
                     const float* __restrict__ lse, const T* __restrict__ dout,
                     const float* __restrict__ delta, int H, int Lq, int Lk,
                     float scale, T* __restrict__ dk, T* __restrict__ dv,
                     float* __restrict__ dbias) {
  using C = Cfg<T, DH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NT = C::NT;
  constexpr int NF = BQ / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Ks = reinterpret_cast<T*>(smem_raw);                 // [BKV][LD]
  T* Vs = Ks + BKV * LD;                                  // [BKV][LD]
  T* ring = Vs + BKV * LD;            // STAGES x (Q [BQ][LD], dO [BQ][LD])
  float* row_ring = reinterpret_cast<float*>(ring + C::STAGES * 2 * C::TILE);
  float* lo = row_ring + C::STAGES * 2 * BQ;  // f32: Q lo, dO lo [BQ][LD]

  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 16;
  const int bh = blockIdx.x, k0 = blockIdx.y * BKV;
  const int b = bh / H, h = bh % H;
  const T* qb = q + (size_t)bh * Lq * DH;
  const T* dob = dout + (size_t)bh * Lq * DH;
  const int n_tiles = (Lq + BQ - 1) / BQ;

  tc::stage_rows(Ks, LD, k + (size_t)bh * Lk * DH, DH, k0, Lk, BKV, 0, DH, DH,
                 tid, NT);
  tc::stage_rows(Vs, LD, v + (size_t)bh * Lk * DH, DH, k0, Lk, BKV, 0, DH, DH,
                 tid, NT);
  // the bias of the thread's two keys (accumulator rows g and g + 8)
  const int g = lane >> 2, qd = lane & 3;
  float key_bias[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + m0 + g + 8 * half;
    key_bias[half] = key >= Lk ? -INFINITY
                     : bias.p  ? bias.p[b * bias.sb + h * bias.sh +
                                       key * bias.sk]
                               : 0.f;
  }

  // query tile t into ring slot t % STAGES: Q, dO, then lse and delta of its
  // rows (+inf and 0 past Lq)
  auto load = [&](int t) {
    if (t < n_tiles) {
      const int slot = t % C::STAGES, q0 = t * BQ;
      T* dst = ring + slot * 2 * C::TILE;
      tc::stage_rows(dst, LD, qb, DH, q0, Lq, BQ, 0, DH, DH, tid, NT);
      tc::stage_rows(dst + C::TILE, LD, dob, DH, q0, Lq, BQ, 0, DH, DH, tid,
                     NT);
      float* rows = row_ring + slot * 2 * BQ;
      for (int i = tid; i < BQ; i += NT) {
        const size_t at = (size_t)bh * Lq + q0 + i;
        if (q0 + i < Lq) {
          tc::cp_async4(rows + i, lse + at, 4);
          tc::cp_async4(rows + BQ + i, delta + at, 4);
        } else {
          rows[i] = INFINITY;
          rows[BQ + i] = 0.f;
        }
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) load(s);

  float acc_k[NO][4], acc_v[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[j][e] = acc_v[j][e] = 0.f;
  float db[2] = {0.f, 0.f};
  const bool want_db = dbias != nullptr;

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait(C::STAGES - 2);
    __syncthreads();   // tile t visible; every warp done with tile t - 1
    load(t + C::STAGES - 1);
    const int slot = t % C::STAGES;
    T* Qt = ring + slot * 2 * C::TILE;
    T* dOt = Qt + C::TILE;
    tc::Planes<T> Qp, dOp;
    if constexpr (C::F32) {
      tc::split_in_place<BQ, DH, LD, NT>(Qt, lo, tid);
      tc::split_in_place<BQ, DH, LD, NT>(dOt, lo + C::TILE, tid);
      __syncthreads();
      Qp = {Qt, lo, LD};
      dOp = {dOt, lo + C::TILE, LD};
    } else {
      Qp = {Qt, LD};
      dOp = {dOt, LD};
    }

    // s^T and dp^T: rows the warp's keys, columns the tile's query rows
    float st[NF][4], dpt[NF][4];
    tc::score_pair<T, NF, DH>(st, dpt, Ks, Vs, LD, m0, Qp, dOp, lane);
    // fragment element e is key g + 8 (e / 2), query row 8j + 2qd + e % 2;
    // p^T into st, g^T into dpt
    const float* row_lse = row_ring + slot * 2 * BQ;
    const float* row_delta = row_lse + BQ;
    float pair[2][NF];   // g^T summed over the thread's two rows of block j
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * qd + (e & 1);
        const float p =
            expf(st[j][e] * scale + key_bias[e >> 1] - row_lse[r]);
        const float gt = p * (dpt[j][e] - row_delta[r]);
        pair[e >> 1][j] = (e & 1) ? pair[e >> 1][j] + gt : gt;
        st[j][e] = p;
        dpt[j][e] = gt;
      }
    // the tile's share of dbias by a pairwise tree over the blocks, then one
    // add: a chain of 2NF dependent adds per tile cost bf16 14% at 128 rows
    if (want_db) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int w = 1; w < NF; w *= 2)
#pragma unroll
          for (int j = 0; j + w < NF; j += 2 * w)
            pair[half][j] += pair[half][j + w];
        db[half] += pair[half][0];
      }
    }
    tc::acc_product<T, NF, NO>(acc_v, st, dOp, lane);
    tc::acc_product<T, NF, NO>(acc_k, dpt, Qp, lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int key = k0 + m0 + g + 8 * half;
    // the quad's four partial sums, in one order on every lane
    float sum = db[half];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    if (key >= Lk) continue;
    const size_t at = ((size_t)bh * Lk + key) * DH + 2 * qd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      from_f32(acc_k[j][2 * half] * scale, dk + at + 8 * j);
      from_f32(acc_k[j][2 * half + 1] * scale, dk + at + 8 * j + 1);
      from_f32(acc_v[j][2 * half], dv + at + 8 * j);
      from_f32(acc_v[j][2 * half + 1], dv + at + 8 * j + 1);
    }
    if (want_db && qd == 0) dbias[(size_t)bh * Lk + key] = sum;
  }
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias,
              const void* lse, const void* dout, const void* delta, int B,
              int H, int Lq, int Lk, void* dk, void* dv, void* dbias,
              cudaStream_t st) {
  using C = Cfg<T, DH>;
  auto kernel = flash_bwd_dkv_kernel<T, DH>;
  constexpr int bytes = static_cast<int>(C::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lk + C::BKV - 1) / C::BKV);
  kernel<<<grid, C::NT, bytes, st>>>(
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
