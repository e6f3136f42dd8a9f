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
// What bounds it: at the serve shape (rows = 64 videos x beam 5 = 320,
// H = 512, V = 11000) the call reads 23.2 MB (W, h) and does
// 2*320*512*11000 = 3.6 GFLOP. In f32 the product runs as three TF32
// tensor-core products (tile_logits_tc.cuh), 10.8 GFLOP at 495 TFLOP/s:
// 0.0218 ms, against 0.0069 ms of memory traffic; bound by operations. In
// bf16, 3.6 GFLOP at 989 TFLOP/s (0.0036 ms) against 11.6 MB (0.0035 ms).
//
// Design. The TPU kernel walks the vocab in order on one core and carries
// the online (max, sumexp) and a running top-K in scratch from one chunk to
// the next. Blocks on the card run in parallel in no order, so this is two
// passes:
//   pass 1, two blocks per vocab tile of BN = 88 columns (250 blocks at
//     V = 11000: one wave at two blocks per SM), each walking every other
//     row tile of BM = 64 rows. W's tile crosses device memory once (the
//     second block and the later row tiles find it in L2); h (655 KB) is
//     read by every block and stays in L2. A block streams (row tile,
//     128-byte depth slice) pairs of h and W through a 3-stage cp.async
//     ring, so the loads of the next slices, and of the next row tile,
//     overlap the products; the other block on the SM keeps the tensor
//     cores busy while this one is in its epilogue. Each of the 4 warps
//     owns 16 rows x 88 columns (11 fragments, 44 accumulators a thread),
//     fed through ldmatrix, and runs mma.sync on them, each depth slice
//     from zero and then added to the sums (tile_logits_tc.cuh,
//     "Accumulation"). At the end of a row tile the logits go once through
//     shared memory, and one thread per row writes the (row, tile) top-K
//     (value, id), a second one the max and the sum of exp relative to it;
//   pass 2 (merge_kernel), one warp per row: merges the row's tiles into
//     (m, s) and picks the row's top-K from the tiles' candidates.
// Columns >= V are masked out as -inf and rows >= rows read as zero (the
// TPU kernel padded them with a -1e30 bias); nothing is padded in memory.
// With bf16 inputs the product accumulates in f32, is rounded to bf16, the
// bias is added in bf16, and the result is taken to f32, as in
// `_stats_pallas`. Top-K picks compare (value, id) pairs, so ties go to the
// lowest id whatever order the tiles are merged in.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes; every pointer and the stream are passed as
// void*. Each entry point launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits_tc.cuh"

namespace {

using namespace care;
using namespace care::tc;

constexpr int HBM = 64;             // rows per row tile: 4 warps x 16
constexpr int HBN = 88;             // vocab columns per block: 11 n8 fragments
constexpr int HNF = HBN / 8;
constexpr int STAGES = 3;           // depth of the cp.async ring
constexpr int HTHREADS = 128;
constexpr int ROW_SPLIT = 2;        // blocks per vocab tile, rows interleaved
constexpr int MTHREADS = 256;       // merge_kernel
constexpr int CS_LD = HBN + 1;

// elements of T in one 128-byte depth slice, and a staged row's stride
// (16 bytes of padding: 36 words, so fragment reads hit 32 distinct banks)
template <typename T>
__host__ __device__ constexpr int slice() { return 128 / sizeof(T); }
template <typename T>
__host__ __device__ constexpr int stage_ld() {
  return slice<T>() + 16 / sizeof(T);
}

// the ring and the logits tile Cs [HBM, CS_LD]
template <typename T>
constexpr size_t smem_bytes() {
  return (size_t)STAGES * (HBM + HBN) * stage_ld<T>() * sizeof(T) +
         (size_t)HBM * CS_LD * sizeof(float);
}
// the top-K lists are KMAX long, in registers: 8 for beams up to 8, else 32
constexpr int MAX_K = 32;

template <typename T, int KMAX>
__global__ void __launch_bounds__(HTHREADS, 2)
head_stats_tc_kernel(const T* __restrict__ h, const T* __restrict__ W,
                     const T* __restrict__ b, int rows, int H, int V, int K,
                     float* __restrict__ part_m, float* __restrict__ part_s,
                     float* __restrict__ part_v, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KC = slice<T>(), LD = stage_ld<T>(), KS = Kstep<T>::value;
  constexpr int STAGE = (HBM + HBN) * LD;
  T* ring = reinterpret_cast<T*>(smem);
  float* Cs = reinterpret_cast<float*>(smem + (size_t)STAGES * STAGE * sizeof(T));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int col0 = blockIdx.x * HBN;
  const int n_tiles = gridDim.x;
  const int nk = (H + KC - 1) / KC;
  // this block's row tiles: blockIdx.y, blockIdx.y + ROW_SPLIT, ...
  const int n_rt = ((rows + HBM - 1) / HBM - (int)blockIdx.y + ROW_SPLIT - 1) /
                   ROW_SPLIT;
  const int total = max(n_rt, 0) * nk;

  // stage (row tile, depth slice) number `it` of the walk; every thread
  // commits a group, empty past the end, so the group count stays uniform
  auto load = [&](int it) {
    if (it < total) {
      const int t = blockIdx.y + ROW_SPLIT * (it / nk), k0 = (it % nk) * KC;
      T* st = ring + (it % STAGES) * STAGE;
      stage_rows<T>(st, LD, h, H, t * HBM, rows, HBM, k0, H, KC, tid, HTHREADS);
      stage_rows<T>(st + HBM * LD, LD, W, H, col0, V, HBN, k0, H, KC, tid,
                    HTHREADS);
    }
    cp_async_commit();
  };
  for (int s = 0; s < STAGES - 1; ++s) load(s);

  float acc[HNF][4];
#pragma unroll
  for (int j = 0; j < HNF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    cp_async_wait(STAGES - 2);
    __syncthreads();                 // slice `it` landed; slot it-1 is free
    load(it + STAGES - 1);
    const int row0 = (blockIdx.y + ROW_SPLIT * (it / nk)) * HBM;
    const bool active = row0 + warp * 16 < rows;
    if (active) {
      const T* As = ring + (it % STAGES) * STAGE;
      const T* Bs = As + HBM * LD;
      // the slice's products from zero, then one f32 add into the sums
      float part[HNF][4];
#pragma unroll
      for (int j = 0; j < HNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
      for (int k0 = 0; k0 < KC; k0 += KS) {
        FragA<T> a;
        ldsm_a(a, As, LD, warp * 16, k0, lane);
#pragma unroll
        for (int j = 0; j + 1 < HNF; j += 2) {
          FragB<T> f0, f1;
          ldsm_b2(f0, f1, Bs, LD, j * 8, k0, lane);
          mma(part[j], a, f0);
          mma(part[j + 1], a, f1);
        }
        if (HNF % 2) {
          FragB<T> fb;
          ldsm_b1(fb, Bs, LD, (HNF - 1) * 8, k0, lane);
          mma(part[HNF - 1], a, fb);
        }
      }
#pragma unroll
      for (int j = 0; j < HNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
    }
    if (it % nk != nk - 1) continue;

    // the row tile is complete: its logits through shared memory
    if (active) {
#pragma unroll
      for (int j = 0; j < HNF; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + (e >= 2 ? 8 : 0);
          const int c = j * 8 + 2 * q + (e & 1);
          const int gc = col0 + c;
          Cs[r * CS_LD + c] = gc < V ? epilogue(acc[j][e], b, gc) : -INFINITY;
        }
    }
#pragma unroll
    for (int j = 0; j < HNF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
    __syncthreads();

    // one thread per row: threads 0-63 the tile's top-K (value, id) of
    // their row, threads 64-127 its max and sum of exp. The top-KMAX list
    // lives in registers, sorted, and each column goes through it by a
    // fixed compare-and-select network: no branch, so the warp never
    // diverges on insertions, which nearly every column brings to one row
    // or another. Columns come in increasing id order, so a value enters
    // only before strictly smaller ones and equal values keep the lower id
    // first. The next write of Cs comes after at least one more
    // __syncthreads of the walk.
    const int r = tid % HBM;
    const int n_cols = min(HBN, V - col0);
    if (row0 + r < rows) {
      const float* x = Cs + r * CS_LD;
      const size_t p = (size_t)(row0 + r) * n_tiles + blockIdx.x;
      if (tid < HBM) {
        float tv[KMAX];
        int ti[KMAX];
#pragma unroll
        for (int k = 0; k < KMAX; ++k) { tv[k] = -INFINITY; ti[k] = -1; }
        for (int c = 0; c < n_cols; ++c) {
          const float v = x[c];
          const int id = col0 + c;
          bool before[KMAX];
#pragma unroll
          for (int k = 0; k < KMAX; ++k) before[k] = v > tv[k];
#pragma unroll
          for (int k = KMAX - 1; k > 0; --k) {
            tv[k] = before[k - 1] ? tv[k - 1] : (before[k] ? v : tv[k]);
            ti[k] = before[k - 1] ? ti[k - 1] : (before[k] ? id : ti[k]);
          }
          tv[0] = before[0] ? v : tv[0];
          ti[0] = before[0] ? id : ti[0];
        }
#pragma unroll
        for (int k = 0; k < KMAX; ++k)
          if (k < K) {
            part_v[p * K + k] = tv[k];
            part_i[p * K + k] = ti[k];
          }
      } else {
        float mx = -INFINITY, sum = 0.f;
        for (int c = 0; c < n_cols; ++c) mx = fmaxf(mx, x[c]);
        for (int c = 0; c < n_cols; ++c) sum += expf(x[c] - mx);
        part_m[p] = mx;
        part_s[p] = sum;
      }
    }
  }
  cp_async_wait(0);
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

template <typename T, int KMAX>
cudaError_t launch_stats(const T* h, const T* W, const T* b, int rows, int H,
                         int V, int K, float* part_m, float* part_s,
                         float* part_v, int* part_i, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      head_stats_tc_kernel<T, KMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  head_stats_tc_kernel<T, KMAX>
      <<<dim3((V + HBN - 1) / HBN, ROW_SPLIT), HTHREADS, bytes, st>>>(
          h, W, b, rows, H, V, K, part_m, part_s, part_v, part_i);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* W, const void* b, int rows, int H,
           int V, int K, void* part_m, void* part_s, void* part_v,
           void* part_i, void* m, void* s, void* cv, void* ids,
           void* stream) {
  if (K < 1 || K > MAX_K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_tiles = (V + HBN - 1) / HBN;
  auto stats = K <= 8 ? launch_stats<T, 8> : launch_stats<T, MAX_K>;
  cudaError_t err = stats(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), rows, H, V, K, static_cast<float*>(part_m),
      static_cast<float*>(part_s), static_cast<float*>(part_v),
      static_cast<int*>(part_i), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_block = MTHREADS / 32;
  merge_kernel<<<(rows + rows_per_block - 1) / rows_per_block, MTHREADS, 0,
                 st>>>(
      static_cast<const float*>(part_m), static_cast<const float*>(part_s),
      static_cast<const float*>(part_v), static_cast<const int*>(part_i), rows,
      n_tiles, K, static_cast<float*>(m), static_cast<float*>(s),
      static_cast<float*>(cv), static_cast<int*>(ids));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// vocab columns per pass-1 block: the wrapper sizes the partials with it
int care_fused_head_topk_tile_cols() { return HBN; }

// the largest K a call takes (the per-row lists live in registers)
int care_fused_head_topk_max_k() { return MAX_K; }

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
