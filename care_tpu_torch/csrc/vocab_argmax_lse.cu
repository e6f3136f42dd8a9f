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
// The [rows, V] logits never reach device memory.
//
// What bounds it: at the flagship's training shape (rows = 64 captions x 29
// positions = 1856, H = 512, V = 11000, f32) the call reads 26.3 MB and does
// 2*1856*512*11000 = 20.9 GFLOP in f32 on the CUDA cores (67 TFLOP/s on an
// H100 SXM): 0.31 ms of arithmetic against 0.008 ms of memory traffic. It is
// bound by operations.
//
// Design. The TPU kernel walks the vocab in order on one core and carries
// (max, sumexp, argmax, token logit, sum) in scratch from chunk to chunk.
// Blocks on the card run in no order, and 1856 rows in 64-row tiles are only
// 29 blocks for 132 SMs, so the vocab is split across blocks too:
//   pass 1, grid (vocab tiles of BN columns) x (row tiles of BM rows): each
//     block forms its tile of the logits in shared memory (tile_logits.cuh)
//     and writes per (row, tile) the tile's max, sum of exp relative to that
//     max, argmax id and sum of logits; the one tile that holds a row's
//     token id writes that logit straight to its output;
//   pass 2, one warp per row: merges the row's tiles. The argmax compares
//     (value, id) pairs, so equal maxima in different tiles resolve to the
//     lowest id whatever the order; the sums are added in a fixed order, so
//     a call repeats bit for bit.
// Columns >= V and rows >= rows are bound-checked, not padded.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits.cuh"

namespace {

using namespace care;

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_stats_tile_kernel(const T* __restrict__ h, const T* __restrict__ W,
                       const T* __restrict__ b,
                       const int* __restrict__ tokens, int rows, int H, int V,
                       int want_sum, float* __restrict__ part_m,
                       float* __restrict__ part_s, int* __restrict__ part_i,
                       float* __restrict__ part_t, float* __restrict__ tok) {
  __shared__ TileSmem sm;

  const int tid = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int row0 = blockIdx.y * BM;
  const int n_tiles = gridDim.x;

  tile_logits<T>(h, W, b, rows, H, V, row0, col0, sm);

  const int warp = tid / 32, lane = tid % 32;
  for (int r = warp; r < BM && row0 + r < rows; r += WARPS) {
    float mx = -INFINITY, tot = 0.f;
    int id = NO_ID;
    float x[BN / 32];
#pragma unroll
    for (int q = 0; q < BN / 32; ++q) {
      int c = lane + 32 * q;
      x[q] = sm.Cs[r][c];
      if (col0 + c < V) {
        if (ranks_before(x[q], col0 + c, mx, id)) { mx = x[q]; id = col0 + c; }
        tot += x[q];
      }
    }
    warp_best(mx, id);
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < BN / 32; ++q)
      if (col0 + lane + 32 * q < V) sum += expf(x[q] - mx);
    for (int o = 16; o > 0; o >>= 1) {
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
      tot += __shfl_xor_sync(0xffffffffu, tot, o);
    }
    if (lane == 0) {
      const size_t p = (size_t)(row0 + r) * n_tiles + blockIdx.x;
      part_m[p] = mx;
      part_s[p] = sum;
      part_i[p] = id;
      if (want_sum) part_t[p] = tot;
      if (tokens) {
        int t = tokens[row0 + r] - col0;
        if (t >= 0 && t < BN && col0 + t < V) tok[row0 + r] = sm.Cs[r][t];
      }
    }
  }
}

__global__ void xent_stats_reduce_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_s,
    const int* __restrict__ part_i, const float* __restrict__ part_t,
    int rows, int n_tiles, int want_sum, int* __restrict__ amax,
    float* __restrict__ mx_out, float* __restrict__ lse,
    float* __restrict__ tot_out) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;

  const size_t base = (size_t)row * n_tiles;
  float m = -INFINITY, s = 0.f, bv = -INFINITY, tot = 0.f;
  int bid = NO_ID;
  for (int t = lane; t < n_tiles; t += 32) {
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

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* tokens,
           int rows, int H, int V, int want_sum, void* part_m, void* part_s,
           void* part_i, void* part_t, void* amax, void* mx, void* lse,
           void* tok, void* tot, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + BN - 1) / BN;
  dim3 grid(n_tiles, (rows + BM - 1) / BM);
  xent_stats_tile_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), static_cast<const int*>(tokens), rows, H, V,
      want_sum, static_cast<float*>(part_m), static_cast<float*>(part_s),
      static_cast<int*>(part_i), static_cast<float*>(part_t),
      static_cast<float*>(tok));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = THREADS / 32;
  xent_stats_reduce_kernel<<<(rows + rows_per_block - 1) / rows_per_block,
                             THREADS, 0, st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const int*>(part_i), static_cast<const float*>(part_t),
      rows, n_tiles, want_sum, static_cast<int*>(amax),
      static_cast<float*>(mx), static_cast<float*>(lse),
      static_cast<float*>(tot));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vocab columns per pass-1 tile: the wrapper sizes the partials with it
int care_vocab_argmax_lse_tile_cols() { return BN; }

// h [rows, H], W [V, H], b [V] or null, all float32; tokens [rows] int32 or
// null; partials part_m/part_s/part_t [rows, n_tiles] f32, part_i
// [rows, n_tiles] int32 (part_t may be null without want_sum); outputs
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
