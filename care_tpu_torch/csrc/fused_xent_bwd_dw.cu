// Backward of the fused softmax cross-entropy statistics with respect to the
// vocab projection and its bias: dW = dlogits^T @ h, db = sum over rows of
// dlogits, with the logits recomputed tile by tile.
//
// Replaces the TPU kernel `_bwd_dw_kernel` of care_tpu/ops/fused_xent.py
// (launched by `_bwd_pallas`). For h [rows, H], W [V, H] (torch's Linear
// layout, so dW is [V, H] too), optional b [V], the forward's lse [rows],
// the cotangents g_lse, g_label, g_sum [rows] (f32) and labels [rows]:
//   x       = h @ W^T + b                    (recomputed, never stored)
//   dlogits = g_lse * exp(x - lse) + g_label * onehot(label) + g_sum
//   dW      = dlogits^T @ h                  [V, H], in W's type
//   db      = sum_rows dlogits               [V], f32
// dlogits is rounded to the input type before the second product, which
// accumulates in f32; db sums the f32 value of the rounded dlogits, as in
// the TPU kernel.
//
// What bounds it: at the flagship's training shape (rows 1856, H 512,
// V 11000, f32) the two products are 4*1856*512*11000 = 41.8 GFLOP in f32 on
// the CUDA cores (67 TFLOP/s on an H100 SXM), 0.62 ms, against 48.9 MB
// (h, W, dW, db and the row vectors) at 3.35 TB/s, 0.015 ms. Bound by
// operations.
//
// Design. The TPU kernel keeps an [H, chunk] f32 accumulator in VMEM and
// walks the row blocks in order. A 128 x 512 f32 accumulator is 256 KB, more
// than an SM's shared memory, and blocks run in no order. So:
//   pass 1, grid (vocab tiles of BN columns) x (row splits): a block walks
//     the row tiles of its split. For each it forms the BM x BN logits tile
//     once (tile_logits.cuh), turns it into dlogits in shared memory, adds
//     its column sums to a register (db), and multiplies its transpose by
//     the tile's BM rows of h in H-slices of BM columns, adding each BN x BM
//     result into its own [BN, H] part of an f32 [V, H] slab in device
//     memory. The part is the block's alone, so the read-modify-write needs
//     no atomics. This costs 2 * 4 * BN * H bytes of L2 traffic per row tile
//     and row_splits * V * H * 4 bytes of scratch (45 MB at the flagship
//     shape, two splits) instead of recomputing the logits per H-slice;
//   pass 2: dW and db = sum over the row splits, in a fixed order.
// No atomics anywhere, so a call repeats bit for bit. The row splits are few
// (one block per SM in flight) because each costs a [V, H] slab. Making it
// fast (wgmma, a shared-memory accumulator over a narrower vocab tile) is
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits.cuh"

namespace {

using namespace care;

constexpr int TARGET_BLOCKS = 132;   // one block per SM of an H100

struct Split {
  int tiles_per_split;
  int splits;
};

Split row_split(int rows, int V) {
  const int row_tiles = (rows + BM - 1) / BM;
  const int n_tiles = (V + BN - 1) / BN;
  int want = (TARGET_BLOCKS + n_tiles - 1) / n_tiles;
  want = want < 1 ? 1 : (want > row_tiles ? row_tiles : want);
  Split s;
  s.tiles_per_split = (row_tiles + want - 1) / want;
  s.splits = (row_tiles + s.tiles_per_split - 1) / s.tiles_per_split;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_dw_tile_kernel(const T* __restrict__ h, const T* __restrict__ W,
                    const T* __restrict__ b, const float* __restrict__ lse,
                    const float* __restrict__ g_lse,
                    const float* __restrict__ g_label,
                    const float* __restrict__ g_sum,
                    const int* __restrict__ labels, int rows, int H, int V,
                    int tiles_per_split, float* __restrict__ part_w,
                    float* __restrict__ part_b) {
  __shared__ TileSmem sm;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int col0 = blockIdx.x * BN;
  const int row_tiles = (rows + BM - 1) / BM;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(row_tiles, t_begin + tiles_per_split);
  float* slab = part_w + (size_t)blockIdx.y * V * H;
  float db = 0.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int row0 = t * BM;
    tile_logits<T>(h, W, b, rows, H, V, row0, col0, sm);
    tile_dlogits<T>(lse, g_lse, g_label, g_sum, labels, rows, V, row0, col0,
                    sm);
    if (tid < BN)
      for (int r = 0; r < BM; ++r) db += sm.Cs[r][tid];

    // slab[col0.., h0..] += dlogits^T [BN, BM] @ h[row0.., h0..] [BM, BM];
    // thread (tx, ty) owns vocab columns ty + 16 j and H columns tx + 16 i
    for (int h0 = 0; h0 < H; h0 += BM) {
      float acc[TN][TM];
#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < TM; ++i) acc[j][i] = 0.f;

      for (int r0 = 0; r0 < BM; r0 += BK) {
        for (int idx = tid; idx < BK * BM; idx += THREADS) {
          int kk = idx / BM, c = idx % BM;
          int gr = row0 + r0 + kk, gh = h0 + c;
          sm.As[kk][c] =
              (gr < rows && gh < H) ? to_f32(h[(size_t)gr * H + gh]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float d[TN], x[TM];
#pragma unroll
          for (int j = 0; j < TN; ++j) d[j] = sm.Cs[r0 + kk][ty + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i) x[i] = sm.As[kk][tx + 16 * i];
#pragma unroll
          for (int j = 0; j < TN; ++j)
#pragma unroll
            for (int i = 0; i < TM; ++i)
              acc[j][i] = fmaf(d[j], x[i], acc[j][i]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int j = 0; j < TN; ++j)
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          int gv = col0 + ty + 16 * j, gh = h0 + tx + 16 * i;
          if (gv < V && gh < H) {
            float* p = slab + (size_t)gv * H + gh;
            *p = t == t_begin ? acc[j][i] : *p + acc[j][i];
          }
        }
    }
  }
  if (tid < BN && col0 + tid < V)
    part_b[(size_t)blockIdx.y * V + col0 + tid] = db;
}

template <typename T>
__global__ void xent_dw_reduce_kernel(const float* __restrict__ part_w,
                                      const float* __restrict__ part_b,
                                      int splits, size_t n, int V,
                                      T* __restrict__ dW,
                                      float* __restrict__ db) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part_w[(size_t)k * n + idx];
  from_f32(s, dW + idx);
  if (idx < (size_t)V) {
    float sb = 0.f;
    for (int k = 0; k < splits; ++k) sb += part_b[(size_t)k * V + idx];
    db[idx] = sb;
  }
}

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* lse,
           const void* g_lse, const void* g_label, const void* g_sum,
           const void* labels, int rows, int H, int V, void* part_w,
           void* part_b, void* dW, void* db, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Split sp = row_split(rows, V);
  dim3 grid((V + BN - 1) / BN, sp.splits);
  xent_dw_tile_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), static_cast<const float*>(g_label),
      static_cast<const float*>(g_sum), static_cast<const int*>(labels), rows,
      H, V, sp.tiles_per_split, static_cast<float*>(part_w),
      static_cast<float*>(part_b));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)V * H;
  xent_dw_reduce_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                             0, st>>>(
      static_cast<const float*>(part_w), static_cast<const float*>(part_b),
      sp.splits, n, V, static_cast<T*>(dW), static_cast<float*>(db));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// how many [V, H] (dW) and [V] (db) f32 slabs of partials a call needs
int care_xent_bwd_dw_splits(int rows, int V) {
  return row_split(rows, V).splits;
}

// h [rows, H], W [V, H], b [V] or null, all float32; lse, g_lse, g_label,
// g_sum [rows] f32; labels [rows] int32; scratch part_w [splits, V, H] and
// part_b [splits, V] f32; outputs dW [V, H] float32, db [V] f32.
int care_xent_bwd_dw_f32(const void* h, const void* W, const void* b,
                         const void* lse, const void* g_lse,
                         const void* g_label, const void* g_sum,
                         const void* labels, int rows, int H, int V,
                         void* part_w, void* part_b, void* dW, void* db,
                         void* stream) {
  return launch<float>(h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H,
                       V, part_w, part_b, dW, db, stream);
}

// the same with h, W, b and dW in bfloat16 (db stays f32)
int care_xent_bwd_dw_bf16(const void* h, const void* W, const void* b,
                          const void* lse, const void* g_lse,
                          const void* g_label, const void* g_sum,
                          const void* labels, int rows, int H, int V,
                          void* part_w, void* part_b, void* dW, void* db,
                          void* stream) {
  return launch<__nv_bfloat16>(h, W, b, lse, g_lse, g_label, g_sum, labels,
                               rows, H, V, part_w, part_b, dW, db, stream);
}

}  // extern "C"
