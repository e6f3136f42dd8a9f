// Backward of the fused softmax cross-entropy statistics with respect to the
// hidden states: dh = dlogits @ W, with the logits recomputed tile by tile.
//
// Replaces the TPU kernel `_bwd_dh_kernel` of care_tpu/ops/fused_xent.py
// (launched by `_bwd_pallas`). For h [rows, H], W [V, H] (torch's Linear
// layout), optional b [V], the forward's lse [rows], the cotangents g_lse,
// g_label, g_sum [rows] (f32) of the statistics (lse, label logit, sum of
// logits) and labels [rows]:
//   x       = h @ W^T + b                    (recomputed, never stored)
//   dlogits = g_lse * exp(x - lse) + g_label * onehot(label) + g_sum
//   dh      = dlogits @ W                    [rows, H], in h's type
// dlogits is rounded to the input type before the second product, which
// accumulates in f32, as in the TPU kernel.
//
// What bounds it: at the flagship's training shape (rows 1856, H 512,
// V 11000, f32) the two products are 4*1856*512*11000 = 41.8 GFLOP in f32 on
// the CUDA cores (67 TFLOP/s on an H100 SXM), 0.62 ms, against 30.2 MB
// (h, W, dh and the row vectors) at 3.35 TB/s, 0.009 ms. Bound by operations.
//
// Design. The TPU kernel keeps a [block_rows, H] f32 accumulator in VMEM
// and walks the vocab chunks in order. A 64 x 512 f32 accumulator is 128 KB:
// it fits neither the registers nor, beside the tile buffers, a block's
// static shared memory, and blocks run in no order. So:
//   pass 1, grid (vocab splits) x (row tiles of BM rows): a block walks the
//     vocab tiles of its split. For each it forms the BM x BN logits tile
//     once (the full reduction over H, tile_logits.cuh), turns it into
//     dlogits in shared memory, and multiplies it by the tile's BN rows of W
//     in H-slices of BN columns, adding each BM x BN result into its own
//     [rows, H] f32 slab of a partials buffer in device memory. The slab is
//     the block's alone, so the read-modify-write needs no atomics, and it
//     stays in L2. This costs 2 * 4 * rows * H bytes of L2 traffic per vocab
//     tile and splits * rows * H * 4 bytes of scratch (38 MB at the flagship
//     shape, ten splits) instead of recomputing the logits once per H-slice;
//   pass 2: dh = sum over the splits, in a fixed order, cast to h's type.
// No atomics anywhere, so a call repeats bit for bit. The number of splits
// is chosen so that about two blocks per SM are in flight. Making it fast
// (wgmma, keeping the accumulator in shared memory) is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include "tile_logits.cuh"

namespace {

using namespace care;

constexpr int TARGET_BLOCKS = 2 * 132;   // two blocks per SM of an H100

struct Split {
  int tiles_per_split;
  int splits;
};

Split vocab_split(int rows, int V) {
  const int row_tiles = (rows + BM - 1) / BM;
  const int n_tiles = (V + BN - 1) / BN;
  int want = (TARGET_BLOCKS + row_tiles - 1) / row_tiles;
  want = want < 1 ? 1 : (want > n_tiles ? n_tiles : want);
  Split s;
  s.tiles_per_split = (n_tiles + want - 1) / want;
  s.splits = (n_tiles + s.tiles_per_split - 1) / s.tiles_per_split;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
xent_dh_tile_kernel(const T* __restrict__ h, const T* __restrict__ W,
                    const T* __restrict__ b, const float* __restrict__ lse,
                    const float* __restrict__ g_lse,
                    const float* __restrict__ g_label,
                    const float* __restrict__ g_sum,
                    const int* __restrict__ labels, int rows, int H, int V,
                    int tiles_per_split, float* __restrict__ part) {
  __shared__ TileSmem sm;

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int n_tiles = (V + BN - 1) / BN;
  const int t_begin = blockIdx.x * tiles_per_split;
  const int t_end = min(n_tiles, t_begin + tiles_per_split);
  float* slab = part + (size_t)blockIdx.x * rows * H;

  for (int t = t_begin; t < t_end; ++t) {
    const int col0 = t * BN;
    tile_logits<T>(h, W, b, rows, H, V, row0, col0, sm);
    tile_dlogits<T>(lse, g_lse, g_label, g_sum, labels, rows, V, row0, col0,
                    sm);

    // slab[row0.., h0..] += dlogits [BM, BN] @ W[col0.., h0..] [BN, BN]
    for (int h0 = 0; h0 < H; h0 += BN) {
      float acc[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

      for (int v0 = 0; v0 < BN; v0 += BK) {
        for (int idx = tid; idx < BK * BN; idx += THREADS) {
          int kk = idx / BN, c = idx % BN;
          int gv = col0 + v0 + kk, gh = h0 + c;
          sm.Bs[kk][c] =
              (gv < V && gh < H) ? to_f32(W[(size_t)gv * H + gh]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < BK; ++kk) {
          float a[TM], w[TN];
#pragma unroll
          for (int i = 0; i < TM; ++i) a[i] = sm.Cs[ty + 16 * i][v0 + kk];
#pragma unroll
          for (int j = 0; j < TN; ++j) w[j] = sm.Bs[kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < TM; ++i)
#pragma unroll
            for (int j = 0; j < TN; ++j)
              acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          int gr = row0 + ty + 16 * i, gh = h0 + tx + 16 * j;
          if (gr < rows && gh < H) {
            float* p = slab + (size_t)gr * H + gh;
            *p = t == t_begin ? acc[i][j] : *p + acc[i][j];
          }
        }
    }
  }
}

template <typename T>
__global__ void xent_dh_reduce_kernel(const float* __restrict__ part,
                                      int splits, size_t n,
                                      T* __restrict__ dh) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= n) return;
  float s = 0.f;
  for (int k = 0; k < splits; ++k) s += part[(size_t)k * n + idx];
  from_f32(s, dh + idx);
}

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* lse,
           const void* g_lse, const void* g_label, const void* g_sum,
           const void* labels, int rows, int H, int V, void* part, void* dh,
           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Split sp = vocab_split(rows, V);
  dim3 grid(sp.splits, (rows + BM - 1) / BM);
  xent_dh_tile_kernel<T><<<grid, THREADS, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(W),
      static_cast<const T*>(b), static_cast<const float*>(lse),
      static_cast<const float*>(g_lse), static_cast<const float*>(g_label),
      static_cast<const float*>(g_sum), static_cast<const int*>(labels), rows,
      H, V, sp.tiles_per_split, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t n = (size_t)rows * H;
  xent_dh_reduce_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS,
                             0, st>>>(static_cast<const float*>(part),
                                      sp.splits, n, static_cast<T*>(dh));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// how many [rows, H] f32 slabs of partials a call needs
int care_xent_bwd_dh_splits(int rows, int V) {
  return vocab_split(rows, V).splits;
}

// h [rows, H], W [V, H], b [V] or null, all float32; lse, g_lse, g_label,
// g_sum [rows] f32; labels [rows] int32; part [splits, rows, H] f32 scratch;
// output dh [rows, H] float32.
int care_xent_bwd_dh_f32(const void* h, const void* W, const void* b,
                         const void* lse, const void* g_lse,
                         const void* g_label, const void* g_sum,
                         const void* labels, int rows, int H, int V,
                         void* part, void* dh, void* stream) {
  return launch<float>(h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H,
                       V, part, dh, stream);
}

// the same with h, W, b and dh in bfloat16
int care_xent_bwd_dh_bf16(const void* h, const void* W, const void* b,
                          const void* lse, const void* g_lse,
                          const void* g_label, const void* g_sum,
                          const void* labels, int rows, int H, int V,
                          void* part, void* dh, void* stream) {
  return launch<__nv_bfloat16>(h, W, b, lse, g_lse, g_label, g_sum, labels,
                               rows, H, V, part, dh, stream);
}

}  // extern "C"
