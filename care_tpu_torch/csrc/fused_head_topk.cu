// Fused vocab projection + per-row softmax statistics + top-K candidates.
//
// Replaces the TPU kernel `_fused_kernel` of care_tpu/ops/fused_head_topk.py
// (launched by `_stats_pallas`). For decoder rows h [rows, H] and the vocab
// projection W, stored as torch keeps a Linear weight ([V, H], each vocab
// column's H values contiguous), and an optional bias b [V], it returns per
// row of the logits x = h @ W^T + b:
//   m   the max over the vocab,
//   s   the sum of exp(x - m) over the vocab,
//   cv  the K largest logits, ids their vocab ids; equal values go to the
//       lowest id first, which is lax.top_k's order.
// The [rows, V] logits never reach device memory.
//
// What bounds it: at the flagship shape (rows = 64 videos x beam 5 = 320,
// H = 512, V = 11000, f32) the call reads 22.5 MB of W and does
// 2*320*512*11000 = 3.6 GFLOP. The product runs in f32 on the CUDA cores
// (no TF32, no tensor cores, so that the f32 path rounds like the plain
// version), where an H100 SXM peaks at 67 TFLOP/s: 54 us of arithmetic
// against 7 us of memory traffic. It is bound by operations.
//
// Design. The TPU kernel walks the vocab in order on one core and carries
// the online (max, sumexp) and a running top-K in scratch from one chunk to
// the next. Blocks on the card run in parallel in no order, so this is two
// passes:
//   pass 1, grid (vocab tiles of BN columns) x (row tiles of BM rows): each
//     block computes its BM x BN tile of the logits with a plain shared-
//     memory tiled product (tile_logits.cuh), keeps it in shared memory, and
//     writes per
//     (row, tile) the tile max, the tile sum of exp relative to that max,
//     and the tile's top-K (value, id);
//   pass 2, one warp per row: merges the row's tiles into (m, s) and picks
//     the row's top-K from the tiles' candidates.
// Columns >= V are masked out (the TPU kernel padded them with a -1e30
// bias). With bf16 inputs the product accumulates in f32, is rounded to
// bf16, the bias is added in bf16, and the result is taken to f32, as in
// `_stats_pallas`. Top-K picks compare (value, id) pairs, so ties go to the
// lowest id whatever order the tiles are merged in. Making it fast (wgmma,
// TMA, a persistent grid) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes; every pointer and the stream are passed as
// void*. Each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits.cuh"

namespace {

using namespace care;

template <typename T>
__global__ void __launch_bounds__(THREADS)
tile_stats_kernel(const T* __restrict__ h, const T* __restrict__ W,
                  const T* __restrict__ b, int rows, int H, int V, int K,
                  float* __restrict__ part_m, float* __restrict__ part_s,
                  float* __restrict__ part_v, int* __restrict__ part_i) {
  __shared__ TileSmem sm;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int n_tiles = gridDim.x;

  tile_logits<T>(h, W, b, rows, H, V, row0, col0, sm);

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM && row0 + r < rows; r += WARPS) {
    float x[BN / 32];
    bool ok[BN / 32];
    float mx = -INFINITY;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      int c = lane + 32 * q;
      x[q] = sm.Cs[r][c];
      ok[q] = col0 + c < V;
      if (ok[q]) mx = fmaxf(mx, x[q]);
    }
    for (int o = 16; o > 0; o >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (ok[q]) sum += expf(x[q] - mx);
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);

    const size_t p = (size_t)(row0 + r) * n_tiles + blockIdx.x;
    if (lane == 0) { part_m[p] = mx; part_s[p] = sum; }

    // K rounds; each picks the best (value, id) that ranks after the
    // previous pick, so no per-lane bookkeeping of what was taken
    float pv = INFINITY;
    int pid = -1;
    for (int t = 0; t < K; ++t) {
      float bv = -INFINITY;
      int bid = NO_ID;
#pragma unroll
      for (int q = 0; q < BN / 32; ++q) {
        int id = col0 + lane + 32 * q;
        if (ok[q] && ranks_before(pv, pid, x[q], id) &&
            ranks_before(x[q], id, bv, bid)) {
          bv = x[q];
          bid = id;
        }
      }
      warp_best(bv, bid);
      if (lane == 0) {
        part_v[p * K + t] = bv;
        part_i[p * K + t] = bid == NO_ID ? -1 : bid;
      }
      pv = bv;
      pid = bid;
    }
  }
}

__global__ void merge_kernel(const float* __restrict__ part_m,
                             const float* __restrict__ part_s,
                             const float* __restrict__ part_v,
                             const int* __restrict__ part_i, int rows,
                             int n_tiles, int K, float* __restrict__ m_out,
                             float* __restrict__ s_out, float* __restrict__ cv,
                             int* __restrict__ ids) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;

  const float* pm = part_m + (size_t)row * n_tiles;
  const float* ps = part_s + (size_t)row * n_tiles;
  float m = -INFINITY, s = 0.f;
  for (int t = lane; t < n_tiles; t += 32) merge_stats(m, s, pm[t], ps[t]);
  for (int o = 16; o > 0; o >>= 1) {
    float m2 = __shfl_xor_sync(0xffffffffu, m, o);
    float s2 = __shfl_xor_sync(0xffffffffu, s, o);
    merge_stats(m, s, m2, s2);
  }
  if (lane == 0) { m_out[row] = m; s_out[row] = s; }

  const int n_cand = n_tiles * K;
  const float* pv = part_v + (size_t)row * n_cand;
  const int* pi = part_i + (size_t)row * n_cand;
  float prev_v = INFINITY;
  int prev_id = -1;
  for (int t = 0; t < K; ++t) {
    float bv = -INFINITY;
    int bid = NO_ID;
    for (int c = lane; c < n_cand; c += 32) {
      int id = pi[c];
      float x = pv[c];
      if (id >= 0 && ranks_before(prev_v, prev_id, x, id) &&
          ranks_before(x, id, bv, bid)) {
        bv = x;
        bid = id;
      }
    }
    warp_best(bv, bid);
    if (lane == 0) {
      cv[(size_t)row * K + t] = bv;
      ids[(size_t)row * K + t] = bid == NO_ID ? -1 : bid;
    }
    prev_v = bv;
    prev_id = bid;
  }
}

template <typename T>
int launch(const void* h, const void* W, const void* b, int rows, int H,
           int V, int K, void* part_m, void* part_s, void* part_v,
           void* part_i, void* m, void* s, void* cv, void* ids,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BN - 1) / BN;
  dim3 grid(n_tiles, (rows + BM - 1) / BM);
  tile_stats_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), rows, H, V, K, static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_v),
      static_cast<int*>(part_i));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = THREADS / 32;
  merge_kernel<<<(rows + rows_per_block - 1) / rows_per_block, THREADS, 0,
                 st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), rows,
      n_tiles, K, static_cast<float*>(m), static_cast<float*>(s),
      static_cast<float*>(cv), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vocab columns per pass-1 tile: the wrapper sizes the partials with it
int care_fused_head_topk_tile_cols() { return BN; }

// h [rows, H], W [V, H], b [V] or null, all float32; partials
// part_m/part_s [rows, n_tiles] f32, part_v [rows, n_tiles, K] f32,
// part_i [rows, n_tiles, K] int32; outputs m/s [rows] f32, cv [rows, K] f32,
// ids [rows, K] int32.
int care_fused_head_topk_f32(const void* h, const void* W, const void* b,
                             int rows, int H, int V, int K, void* part_m,
                             void* part_s, void* part_v, void* part_i,
                             void* m, void* s, void* cv, void* ids,
                             void* stream) {
  return launch<float>(h, W, b, rows, H, V, K, part_m, part_s, part_v, part_i,
                       m, s, cv, ids, stream);
}

// the same with h, W and b in bfloat16
int care_fused_head_topk_bf16(const void* h, const void* W, const void* b,
                              int rows, int H, int V, int K, void* part_m,
                              void* part_s, void* part_v, void* part_i,
                              void* m, void* s, void* cv, void* ids,
                              void* stream) {
  return launch<__nv_bfloat16>(h, W, b, rows, H, V, K, part_m, part_s, part_v,
                               part_i, m, s, cv, ids, stream);
}

}  // extern "C"
