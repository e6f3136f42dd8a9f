// Per-row statistics of the vocab logits without the logits: first-occurrence
// argmax, max logit, log-sum-exp, the logit at a given token (label) id, and
// the sum of the logits over the vocab.
//
// Replaces the TPU kernel `_argmax_lse_kernel` of
// care_tpu/ops/fused_head_topk.py (launched by `_argmax_lse_pallas`): the
// forward of the fused softmax cross-entropy of training
// (`vocab_xent_stats`) and the serving entry `vocab_argmax_lse`. For rows
// h [rows, H], the projection W [V, H] (torch's Linear layout) and an
// optional bias b [V], per row of x = h @ W^T + b:
//   amax  argmax over the vocab, the lowest id among equal maxima,
//   mx    the max logit,
//   lse   log(sum(exp(x))),
//   tok   x[token id] (0 when the id lies outside [0, V); skipped when no
//         ids are given),
//   tot   sum(x) over the V real columns (skipped when not asked for).
// The [rows, V] logits never reach device memory. With bf16 inputs the
// product accumulates in f32, is rounded to bf16, the bias is added in
// bf16, and the result is taken to f32, as in the TPU kernel.
//
// What bounds it: at the flagship's training shape (rows = 64 captions x 29
// positions = 1856, H = 512, V = 11000, f32) the product is 2*1856*512*11000
// = 20.9 GFLOP. f32 runs as three TF32 products on the tensor cores
// (tile_logits_tc.cuh): 62.7 GFLOP, 0.127 ms at the data sheet's 495 TFLOP/s
// and 0.205 ms at the 306 TFLOP/s that mma.sync reaches on an H100
// (care_tpu_torch/tools/kernel_probe.py), against 26.3 MB (h, W, the row
// vectors) at 3.35 TB/s, 0.008 ms. Bound by operations. In bf16 one
// product, 0.021 ms at 989 TFLOP/s.
//
// Design. The TPU kernel walks the vocab in order on one core and carries
// (max, sumexp, argmax, token logit, sum) in scratch from chunk to chunk.
// Here a block owns a row tile of 64 rows and walks a share of the vocab,
// carrying those statistics in registers:
//   pass 1, grid (row tiles) x (vocab splits): 1856 rows are 29 row tiles,
//     and the vocab is cut into as many splits as fill the card in two waves
//     of one block per SM (9 at the flagship shape: 261 blocks of 20 or 12
//     vocab tiles of 64 columns). The block's h tile [64, H] is staged once
//     and stays in shared memory; W comes in as 64 x 64 chunks (one depth
//     chunk of one vocab tile, 16 KB in f32) through a 4-stage cp.async
//     ring, so three chunks are in flight while one is multiplied. Each of
//     the 8 warps owns 16 rows x 32 columns of the [64, 64] logits tile
//     (four n8 fragments, 16 independent mma chains) and forms them with
//     chunk_logits (tile_logits_tc.cuh): the depth walks in 64-wide chunks,
//     each from zero in four accumulator sets, then added, the order K3a and
//     K3b recompute the logits in, so the lse a row gets here is taken over
//     the same logits, bit for bit, as the softmax of the backward. When a
//     vocab tile's last chunk is in, each thread folds its 2 rows x 8
//     columns into its running (max, sum of exp), (value, id) best and sum,
//     in registers; the thread that holds a row's token column writes that
//     logit straight to its output. At the end the four lanes of a quad
//     and then the two column warps merge in a fixed order, and one thread
//     per row writes the split's partial;
//   pass 2, one warp per row: merges the row's splits. The argmax compares
//     (value, id) pairs, so equal maxima in different splits resolve to the
//     lowest id whatever the order; the sums are added in a fixed order, so
//     a call repeats bit for bit.
// Feeding the tensor cores: per warp and mma step of the logits the warp
// reads 1536 bytes of shared memory (one ldmatrix.x4 of h, two of W) for 12
// tensor-core instructions in f32 (three per product), 128 bytes each, and
// 384 in bf16. K3b's logits half, whose 16 x 16 warp tiles read 171 (f32)
// and 512 (bf16) bytes per instruction behind a single-buffered refill of h
// and a barrier per 64-deep chunk for 8 warps, took 0.84 ms at this shape
// without its dW product (PERF.md, kernel_probe): here the warp tile is
// twice as wide, the ring three chunks deep, and the statistics never
// leave the registers. L2 traffic: W is read once per row tile, 29 x 22.5
// MB = 653 MB, and h once per block, 261 x 131 KB = 34 MB. Where h's tile
// does not fit beside the ring (f32 beyond H 576, bf16 beyond H 1152) the
// ring carries h's chunk beside W's instead, re-read from L2 per vocab tile.
// Columns >= V and rows >= rows are bound-checked or zero-filled, not
// padded in memory.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits_tc.cuh"

namespace {

using namespace care;
using namespace care::tc;

constexpr int SBM = 64;             // rows per block: 4 warps x 16
constexpr int SBN = 64;             // vocab columns per tile: 2 warps x 32
constexpr int SNF = 4;              // n8 fragments of a warp's 32 columns
constexpr int STHREADS = 256;       // 8 warps
constexpr int KCH = LOGIT_CHUNK;    // depth of a ring chunk
constexpr int NST = 4;              // ring depth
constexpr size_t MAX_SMEM = 232448; // an H100 block's dynamic shared memory

// row stride, in elements of T, of the resident h tile: H rounded up to
// whole chunks, plus 16 bytes
template <typename T> int tile_ld(int H) {
  return (H + KCH - 1) / KCH * KCH + 16 / (int)sizeof(T);
}
// a ring chunk's row stride (16 bytes of padding: ldmatrix without bank
// conflicts)
template <typename T> __host__ __device__ constexpr int ring_ld() {
  return KCH + 16 / sizeof(T);
}
// one ring slot: W's chunk [64, KCH]; streaming, h's chunk [64, KCH] too
template <typename T> __host__ __device__ constexpr int ring_slot(bool stream) {
  return (stream ? SBN + SBM : SBN) * ring_ld<T>();
}
// the ring, then (resident) h's tile; the end-of-walk hand-over of the
// statistics reuses the ring
template <typename T> size_t smem_bytes(int H, bool stream) {
  return ((size_t)NST * ring_slot<T>(stream) +
          (stream ? 0 : (size_t)SBM * tile_ld<T>(H))) * sizeof(T);
}

template <typename T, bool STREAM>
__global__ void __launch_bounds__(STHREADS, 1)
xent_stats_tc_kernel(const T* __restrict__ h, const T* __restrict__ W,
                     const T* __restrict__ b, const int* __restrict__ tokens,
                     int rows, int H, int V, int ld, int tiles_per_split,
                     int want_sum, float* __restrict__ part_m,
                     float* __restrict__ part_s, int* __restrict__ part_i,
                     float* __restrict__ part_t, float* __restrict__ tok) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int RLD = ring_ld<T>(), SLOT = ring_slot<T>(STREAM);
  T* ring = reinterpret_cast<T*>(smem);
  T* Hs = ring + (size_t)NST * SLOT;        // resident h [64, ld]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  // this warp's logits: rows 16 * mi.., columns 32 * ni.. of the tile
  const int mi = warp & 3, ni = warp >> 2;
  const int row0 = blockIdx.x * SBM;
  const int nch = (H + KCH - 1) / KCH;
  const int n_tiles = (V + SBN - 1) / SBN;
  const int t0 = blockIdx.y * tiles_per_split;
  const int total = max(min(n_tiles, t0 + tiles_per_split) - t0, 0) * nch;

  // stage (vocab tile, depth chunk) number `it` of the walk; every thread
  // commits a group, empty past the end, so the group count stays uniform
  auto load = [&](int it) {
    if (it < total) {
      const int col0 = (t0 + it / nch) * SBN, k0 = (it % nch) * KCH;
      T* st = ring + (size_t)(it % NST) * SLOT;
      stage_rows<T>(st, RLD, W, H, col0, V, SBN, k0, H, KCH, tid, STHREADS);
      if constexpr (STREAM)
        stage_rows<T>(st + SBN * RLD, RLD, h, H, row0, rows, SBM, k0, H, KCH,
                      tid, STHREADS);
    }
    cp_async_commit();
  };
  if constexpr (!STREAM) {
    stage_rows<T>(Hs, ld, h, H, row0, rows, SBM, 0, H, nch * KCH, tid,
                  STHREADS);
    cp_async_commit();
  }
  for (int s = 0; s < NST - 1; ++s) load(s);

  // this thread's two rows: running (max, sum of exp), best (value, id),
  // sum of logits, and the token id
  float m[2], se[2], bv[2], tot[2];
  int bid[2], tk[2];
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int gr = row0 + 16 * mi + g + 8 * u;
    m[u] = bv[u] = -INFINITY;
    se[u] = tot[u] = 0.f;
    bid[u] = NO_ID;
    tk[u] = tokens && gr < rows ? tokens[gr] : -1;
  }

  float x[SNF][4];
  for (int it = 0; it < total; ++it) {
    cp_async_wait(NST - 2);
    __syncthreads();                  // chunk `it` landed; slot it-1 is free
    load(it + NST - 1);
    const int c = it % nch;
    if (c == 0)
#pragma unroll
      for (int j = 0; j < SNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    const T* Wc = ring + (size_t)(it % NST) * SLOT;
    const T* Ac = STREAM ? Wc + SBN * RLD : Hs + c * KCH;
    chunk_logits<T, SNF>(x, Ac, STREAM ? RLD : ld, 16 * mi, Wc, RLD, 32 * ni,
                         lane);
    if (c != nch - 1) continue;

    // the vocab tile is complete: fold its logits into the row statistics,
    // columns in increasing id order
    const int col0 = (t0 + it / nch) * SBN + 32 * ni + 2 * q;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float v[SNF][2], mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < SNF; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p) {
          const int gc = col0 + 8 * j + p;
          v[j][p] = -INFINITY;
          if (gc < V) {
            const float lv = epilogue(x[j][2 * u + p], b, gc);
            v[j][p] = lv;
            if (ranks_before(lv, gc, bv[u], bid[u])) {
              bv[u] = lv;
              bid[u] = gc;
            }
            mt = fmaxf(mt, lv);
            tot[u] += lv;
            if (gc == tk[u]) tok[row0 + 16 * mi + g + 8 * u] = lv;
          }
        }
      if (mt != -INFINITY) {
        float st = 0.f;
#pragma unroll
        for (int j = 0; j < SNF; ++j)
#pragma unroll
          for (int p = 0; p < 2; ++p) st += expf(v[j][p] - mt);
        merge_stats(m[u], se[u], mt, st);
      }
    }
  }

  // merge the four lanes of a quad (same rows), then the two column warps
  // through shared memory (the ring's space, free now), in a fixed order
  cp_async_wait(0);
  __syncthreads();
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m[u], o);
      const float s2 = __shfl_xor_sync(0xffffffffu, se[u], o);
      merge_stats(m[u], se[u], m2, s2);
      const float ov = __shfl_xor_sync(0xffffffffu, bv[u], o);
      const int oid = __shfl_xor_sync(0xffffffffu, bid[u], o);
      if (ranks_before(ov, oid, bv[u], bid[u])) { bv[u] = ov; bid[u] = oid; }
      tot[u] += __shfl_xor_sync(0xffffffffu, tot[u], o);
    }
  // [2][64] each; a row's best value is its max
  float* red_m = reinterpret_cast<float*>(smem);
  float* red_s = red_m + 2 * SBM;
  float* red_t = red_s + 2 * SBM;
  int* red_i = reinterpret_cast<int*>(red_t + 2 * SBM);
  if (q == 0)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int r = ni * SBM + 16 * mi + g + 8 * u;
      red_m[r] = m[u];
      red_s[r] = se[u];
      red_t[r] = tot[u];
      red_i[r] = bid[u];
    }
  __syncthreads();
  if (tid < SBM && row0 + tid < rows) {
    float M = -INFINITY, S = 0.f, BV = -INFINITY, TT = 0.f;
    int BI = NO_ID;
    for (int k = 0; k < 2; ++k) {
      const int r = k * SBM + tid;
      merge_stats(M, S, red_m[r], red_s[r]);
      if (ranks_before(red_m[r], red_i[r], BV, BI)) {
        BV = red_m[r];
        BI = red_i[r];
      }
      TT += red_t[r];
    }
    const size_t p = (size_t)(row0 + tid) * gridDim.y + blockIdx.y;
    part_m[p] = M;
    part_s[p] = S;
    part_i[p] = BI;
    if (want_sum) part_t[p] = TT;
  }
}

__global__ void xent_stats_reduce_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const int* __restrict__ part_i, const float* __restrict__ part_t,
    int rows, int n_parts, int want_sum, int* __restrict__ amax,
    float* __restrict__ mx_out, float* __restrict__ lse,
    float* __restrict__ tot_out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;

  const size_t base = (size_t)row * n_parts;
  float m = -INFINITY, s = 0.f, bv = -INFINITY, tot = 0.f;
  int bid = NO_ID;
  for (int t = lane; t < n_parts; t += 32) {
    float tm = part_m[base + t];
    merge_stats(m, s, tm, part_s[base + t]);
    int id = part_i[base + t];
    if (ranks_before(tm, id, bv, bid)) { bv = tm; bid = id; }
    if (want_sum) tot += part_t[base + t];
  }
  for (int o = 16; o > 0; o >>= 1) {
    float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_stats(m, s, m2, s2);
    tot += __shfl_xor_sync(0xffffffffu, tot, o);
  }
  warp_best(bv, bid);
  if (lane == 0) {
    amax[row] = bid;
    mx_out[row] = bv;
    lse[row] = m + logf(s);
    if (want_sum) tot_out[row] = tot;
  }
}

struct Split {
  int tiles_per_split;
  int splits;
};

// vocab splits that fill the card's SMs in about two waves of one block
Split vocab_split(int rows, int V) {
  int sms = 132, dev = 0;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int row_tiles = rows > SBM ? (rows + SBM - 1) / SBM : 1;
  const int n_tiles = V > SBN ? (V + SBN - 1) / SBN : 1;
  int want = 2 * sms / row_tiles;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  Split s;
  s.tiles_per_split = (n_tiles + want - 1) / want;
  s.splits = (n_tiles + s.tiles_per_split - 1) / s.tiles_per_split;
  return s;
}

template <typename T, bool STREAM>
cudaError_t launch_stats(const T* h, const T* W, const T* b,
                         const int* tokens, int rows, int H, int V,
                         int want_sum, Split sp, float* part_m, float* part_s,
                         int* part_i, float* part_t, float* tok,
                         cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(H, STREAM);
  cudaError_t err = cudaFuncSetAttribute(
      xent_stats_tc_kernel<T, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + SBM - 1) / SBM, sp.splits);
  xent_stats_tc_kernel<T, STREAM><<<grid, STHREADS, bytes, st>>>(
      h, W, b, tokens, rows, H, V, tile_ld<T>(H), sp.tiles_per_split,
      want_sum, part_m, part_s, part_i, part_t, tok);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* tokens,
           int rows, int H, int V, int want_sum, void* part_m, void* part_s,
           void* part_i, void* part_t, void* amax, void* mx, void* lse,
           void* tok, void* tot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Split sp = vocab_split(rows, V);
  // h's tile resident where it fits beside the ring, else streamed
  auto stats = smem_bytes<T>(H, false) <= MAX_SMEM ? launch_stats<T, false>
                                                    : launch_stats<T, true>;
  cudaError_t err = stats(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), static_cast<const int*>(tokens), rows, H, V,
      want_sum, sp, static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(part_t),
      static_cast<float*>(tok), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = THREADS / 32;
  xent_stats_reduce_kernel<<<(rows + rows_per_block - 1) / rows_per_block,
                             THREADS, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), static_cast<const float*>(part_t),
      rows, sp.splits, want_sum, static_cast<int*>(amax),
      static_cast<float*>(mx), static_cast<float*>(lse),
      static_cast<float*>(tot));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// partials per row (vocab splits) of a call on the current device: the
// wrapper sizes the partials with it
int care_vocab_argmax_lse_parts(int rows, int V) {
  return vocab_split(rows, V).splits;
}

// h [rows, H], W [V, H], b [V] or null, all float32; tokens [rows] int32 or
// null; partials part_m/part_s/part_t [rows, parts] f32, part_i
// [rows, parts] int32 (part_t may be null without want_sum); outputs
// amax [rows] int32, mx/lse [rows] f32, tok [rows] f32 zero-filled by the
// caller (null without tokens), tot [rows] f32 (null without want_sum).
int care_vocab_argmax_lse_f32(const void* h, const void* W, const void* b,
                              const void* tokens, int rows, int H, int V,
                              int want_sum, void* part_m, void* part_s,
                              void* part_i, void* part_t, void* amax,
                              void* mx, void* lse, void* tok, void* tot,
                              void* stream) {
  return launch<float>(h, W, b, tokens, rows, H, V, want_sum, part_m, part_s,
                       part_i, part_t, amax, mx, lse, tok, tot, stream);
}

// the same with h, W and b in bfloat16
int care_vocab_argmax_lse_bf16(const void* h, const void* W, const void* b,
                               const void* tokens, int rows, int H, int V,
                               int want_sum, void* part_m, void* part_s,
                               void* part_i, void* part_t, void* amax,
                               void* mx, void* lse, void* tok, void* tot,
                               void* stream) {
  return launch<__nv_bfloat16>(h, W, b, tokens, rows, H, V, want_sum, part_m,
                               part_s, part_i, part_t, amax, mx, lse, tok, tot,
                               stream);
}

}  // extern "C"
