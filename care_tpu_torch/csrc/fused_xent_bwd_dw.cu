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
// V 11000) the two products are 4*1856*512*11000 = 41.8 GFLOP. In f32 both
// run as three TF32 tensor-core products (tile_logits_tc.cuh): 125 GFLOP at
// 495 TFLOP/s, 0.253 ms, against 48.9 MB (h, W, dW, db and the row vectors)
// at 3.35 TB/s, 0.015 ms. Bound by operations. In bf16 one product each,
// 0.042 ms at 989 TFLOP/s.
//
// Design: the ownership of K4c (flash_attention_bwd_dkv.cu). A cluster of
// two blocks owns a vocab tile of BN = 64 columns; each block walks every
// other row tile of BM = 32 rows:
//   - its W tile [64, H] is staged once into shared memory (cp.async, in
//     64-wide depth chunks, one group each) and stays for the whole walk;
//   - each row tile of h [32, H] is staged the same way into one buffer,
//     chunk c by warp c % 8. The logits product takes each depth chunk as
//     soon as its group lands; a warp refills its chunks for the next row
//     tile as soon as its own dW product (which reads only those chunks)
//     is done;
//   - the logits tile [32, 64]: each warp owns 16 rows x 16 columns, fed
//     through ldmatrix, by chunk_logits (tile_logits_tc.cuh): four
//     accumulator sets (depth steps mod 4), so that eight independent mma
//     chains are in flight, started from zero for each 64-wide depth chunk
//     and then added to the logits, chunk after chunk. K2 and K3a form
//     their logits through the same function in the same chunk order, so
//     a column's logit is bit-identical here, in K3a and in the lse of the
//     forward (K2), and equal columns give bit-equal logits;
//   - dlogits (tile_logits.cuh's rule) are formed from the accumulators in
//     registers and written once to shared memory, rounded to T; their
//     column sums for db go through shuffles in a fixed order;
//   - dW [64, 512] accumulates in registers across the whole walk: warp w
//     owns H columns [64w, 64w + 64), 4 x 8 fragments, 128 f32 a thread,
//     fed by dlogits^T (A) and the staged h rows (B); each fragment's
//     product over one depth step runs from zero and is added to its sums
//     with an f32 add, so the sums round to nearest;
//   - at the end the second block of the cluster hands its partial dW and
//     db to the first through distributed shared memory, which adds them
//     in a fixed order and writes dW and db.
// No device-memory partials, no reduce pass, no atomics: a call repeats bit
// for bit. At V = 11000 the grid is 344 blocks, one per SM (255 registers,
// up to 207 KB of shared memory): three waves of half the row walk, where
// 172 whole walks took two waves, the second only 40 blocks wide.
// H wider than 512 takes more clusters along the grid's z axis, each owning
// 512 of dW's columns and recomputing the logits. Where W's [64, H] tile and
// h's [32, H] row tile do not fit shared memory together (f32 beyond H 576,
// bf16 beyond H 1152: the `median` and `large` presets in f32), the kernel
// streams instead: the logits product takes W's and h's depth chunks
// through a 3-stage cp.async ring, re-reading W's tile from L2 for every
// row tile, and only h's columns of the block's dW slice stay staged for
// the dW product. Every H is taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError().

#include <cooperative_groups.h>

#include "tile_logits_tc.cuh"

namespace {

using namespace care;
using namespace care::tc;

constexpr int DBN = 64;             // vocab columns per block
constexpr int DBM = 32;             // rows per row tile
constexpr int DTHREADS = 256;       // 8 warps
constexpr int DHP = 512;            // dW columns per block: 8 warps x 64
constexpr int KCH = LOGIT_CHUNK;    // depth chunk of the staged tiles
constexpr int DS_LD = DBN + 8;      // dlogits [32, 64] row stride (floats)
constexpr size_t MAX_SMEM = 232448; // an H100 block's dynamic shared memory
constexpr int DSPLIT = 2;           // blocks of a cluster sharing a vocab tile
constexpr int NST = 3;              // depth of the streaming variant's ring
// the partial dW [64, 512] and db [64] a block hands to its cluster's first
constexpr size_t RED_BYTES = (size_t)(DBN * DHP + DBN) * sizeof(float);

// row stride, in elements of T, of the staged W and h tiles: H rounded up
// to whole chunks, plus 16 bytes
template <typename T> int tile_ld(int H) {
  return (H + KCH - 1) / KCH * KCH + 16 / (int)sizeof(T);
}

// the streaming variant's row strides: a ring slot's depth chunk, and h's
// row tile over one block's dW columns
template <typename T> __host__ __device__ constexpr int ring_ld() {
  return KCH + 16 / sizeof(T);
}
template <typename T> __host__ __device__ constexpr int slice_ld() {
  return DHP + 16 / sizeof(T);
}
// one ring slot: W's chunk [64, KCH], then h's [32, KCH]
template <typename T> __host__ __device__ constexpr int ring_slot() {
  return (DBN + DBM) * ring_ld<T>();
}

// resident: W's tile [64, H] and h's row tile [32, H]; streaming: the ring
// and h's row tile over the block's dW columns [32, 512]. Then dlogits and
// the db sums; the cluster's hand-over reuses the space at the end.
template <typename T> size_t smem_bytes(int H, bool stream) {
  const size_t elems =
      stream ? (size_t)NST * ring_slot<T>() + (size_t)DBM * slice_ld<T>()
             : (size_t)(DBN + DBM) * tile_ld<T>(H);
  const size_t tiles =
      elems * sizeof(T) + (size_t)(DBM * DS_LD + 2 * DBN) * sizeof(float);
  return tiles > RED_BYTES ? tiles : RED_BYTES;
}

template <typename T, bool STREAM>
__global__ void __cluster_dims__(1, DSPLIT, 1) __launch_bounds__(DTHREADS, 1)
xent_dw_tc_kernel(const T* __restrict__ h, const T* __restrict__ W,
                  const T* __restrict__ b, const float* __restrict__ lse,
                  const float* __restrict__ g_lse,
                  const float* __restrict__ g_label,
                  const float* __restrict__ g_sum,
                  const int* __restrict__ labels, int rows, int H, int V,
                  int ld, T* __restrict__ dW, float* __restrict__ db) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = Kstep<T>::value;
  constexpr int RLD = ring_ld<T>(), SLOT = ring_slot<T>();
  // resident: W's tile, then h's row tile (row stride ld); streaming: the
  // ring, then h's row tile over this block's dW columns
  T* Ws = reinterpret_cast<T*>(smem);
  T* Hs = Ws + (STREAM ? (size_t)NST * SLOT : (size_t)DBN * ld);
  const int hld = STREAM ? slice_ld<T>() : ld;
  float* Ds = reinterpret_cast<float*>(Hs + (size_t)DBM * hld);
  float* Dbs = Ds + DBM * DS_LD;      // [2][64]: column sums of 16 rows

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int col0 = blockIdx.x * DBN;
  const int hp0 = blockIdx.z * DHP;
  const int nch = (H + KCH - 1) / KCH;
  const int row_tiles = (rows + DBM - 1) / DBM;
  // the logits fragment of this warp: rows 16 * mi.., columns 16 * ni..
  const int mi = warp & 1, ni = warp >> 1;
  // the dW columns of this warp, and where they lie in the staged h tile
  const int wh0 = hp0 + 64 * warp;
  const int hoff = STREAM ? 64 * warp : wh0;

  // streaming: depth chunk c of W's tile and of h's row tile at row0 into
  // ring slot c % NST; every thread commits a group, empty past the end
  auto stage_chunk = [&](int row0, int c) {
    if (c < nch) {
      T* st = Ws + (size_t)(c % NST) * SLOT;
      stage_rows<T>(st, RLD, W, H, col0, V, DBN, c * KCH, H, KCH, tid,
                    DTHREADS);
      stage_rows<T>(st + DBN * RLD, RLD, h, H, row0, rows, DBM, c * KCH, H,
                    KCH, tid, DTHREADS);
    }
    cp_async_commit();
  };

  // Depth chunk c of the staged tiles is loaded by warp c % 8, one
  // cp.async group each: the chunks of dW's columns that a warp owns are
  // the ones it reads in the dW product, so it refills them for the next
  // row tile as soon as its own product is done. W's tile comes in with
  // the first row tile of h.
  if constexpr (!STREAM)
    for (int c = warp; c < nch; c += 8) {
      stage_rows<T>(Ws + c * KCH, ld, W, H, col0, V, DBN, c * KCH, H, KCH,
                    lane, 32);
      stage_rows<T>(Hs + c * KCH, ld, h, H, blockIdx.y * DBM, rows, DBM,
                    c * KCH, H, KCH, lane, 32);
      cp_async_commit();
    }

  float acc[4][8][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  float db_acc = 0.f;

  // this block's row tiles: blockIdx.y, blockIdx.y + DSPLIT, ...
  for (int t = blockIdx.y; t < row_tiles; t += DSPLIT) {
    const int row0 = t * DBM;
    if constexpr (STREAM) {
      __syncthreads();            // the last row tile's dW product is done
      stage_rows<T>(Hs, hld, h, H, row0, rows, DBM, hp0, H, DHP, tid,
                    DTHREADS);
      cp_async_commit();
      for (int c = 0; c < NST - 1; ++c) stage_chunk(row0, c);
    }

    // the row vectors of this thread's two dlogits rows, read now so that
    // their latency hides under the logits product
    float v_lse[2], v_gl[2], v_gb[2], v_gs[2];
    int v_lab[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int gr = row0 + 16 * mi + g + 8 * u;
      const bool in = gr < rows;
      v_lse[u] = in ? lse[gr] : 0.f;
      v_gl[u] = in ? g_lse[gr] : 0.f;
      v_gb[u] = in ? g_label[gr] : 0.f;
      v_gs[u] = in ? g_sum[gr] : 0.f;
      v_lab[u] = in ? labels[gr] : -1;
    }

    // logits [32, 64]: x[n fragment][4], chunk by chunk (chunk_logits)
    float x[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const T *Wc, *Hc;
      int lc;
      if constexpr (STREAM) {
        cp_async_wait(NST - 2);
        __syncthreads();          // chunk c landed; slot c - 1 is free
        stage_chunk(row0, c + NST - 1);
        Wc = Ws + (size_t)(c % NST) * SLOT;
        Hc = Wc + DBN * RLD;
        lc = RLD;
      } else {
        if (warp == c % 8) cp_async_wait((nch - 1 - c) / 8);
        __syncthreads();
        Wc = Ws + c * KCH;
        Hc = Hs + c * KCH;
        lc = ld;
      }
      chunk_logits<T, 2>(x, Hc, lc, 16 * mi, Wc, lc, 16 * ni, lane);
    }

    // dlogits, rounded to T, into shared memory; 0 outside rows x V. The
    // column sums for db: this thread's two rows, then the warp's 16 rows
    // by shuffles, in a fixed order
    float cs[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int u = e >> 1;
        const int r = 16 * mi + g + 8 * u;
        const int c = 16 * ni + 8 * j + 2 * q + (e & 1);
        const int gr = row0 + r, gc = col0 + c;
        float d = 0.f;
        if (gr < rows && gc < V) {
          const float logit = epilogue(x[j][e], b, gc);
          d = v_gl[u] * expf(logit - v_lse[u]) +
              (gc == v_lab[u] ? v_gb[u] : 0.f) + v_gs[u];
          d = round_as(d, static_cast<const T*>(nullptr));
        }
        Ds[r * DS_LD + c] = d;
        cs[j][e & 1] += d;
      }
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          cs[j][p] += __shfl_xor_sync(0xffffffffu, cs[j][p], o);
    if (g == 0)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int p = 0; p < 2; ++p)
          Dbs[mi * DBN + 16 * ni + 8 * j + 2 * q + p] = cs[j][p];
    __syncthreads();

    if (tid < DBN) db_acc += Dbs[tid] + Dbs[DBN + tid];

    // dW[64, this warp's 64 columns] += dlogits^T [64, 32] @ h [32, 64]:
    // each fragment's product over one depth step runs from zero and is
    // added to the sums with an f32 add, so that h's fragments are read
    // once and no partial sums need registers beside dW's
    if (wh0 < H) {
#pragma unroll
      for (int s = 0; s < DBM / KS; ++s) {
        FragA<T> a[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          load_a_transposed(a[i], Ds, DS_LD, 16 * i, s * KS, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (wh0 + 8 * j < H) {
            FragB<T> fb;
            load_b_kmajor(fb, Hs, hld, s * KS, hoff + 8 * j, lane);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma(d, a[i], fb);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
            }
          }
        }
      }
    }

    // this warp's chunks of the next row tile of h: no other warp reads
    // them any more (the logits product is behind the last barrier)
    if (!STREAM && t + DSPLIT < row_tiles)
      for (int c = warp; c < nch; c += 8) {
        stage_rows<T>(Hs + c * KCH, ld, h, H, row0 + DSPLIT * DBM, rows, DBM,
                      c * KCH, H, KCH, lane, 32);
        cp_async_commit();
      }
  }

  // The cluster's blocks summed disjoint row tiles: the others hand their
  // partial sums to the first through distributed shared memory (the tiles'
  // space, free now), which adds them in rank order and writes dW and db.
  cp_async_wait(0);
  __syncthreads();
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float* red = reinterpret_cast<float*>(smem);
  if (rank != 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((i * 8 + j) * 4 + e) * DTHREADS + tid] = acc[i][j][e];
    if (tid < DBN) red[DBN * DHP + tid] = db_acc;
  }
  cluster.sync();
  if (rank == 0) {
    for (int from = 1; from < DSPLIT; ++from) {
      const float* other = cluster.map_shared_rank(red, from);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += other[((i * 8 + j) * 4 + e) * DTHREADS + tid];
      if (tid < DBN) db_acc += other[DBN * DHP + tid];
    }
  }
  // the others' shared memory stays until the first has read it
  cluster.sync();
  if (rank != 0) return;

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gv = col0 + 16 * i + g + (e >= 2 ? 8 : 0);
        const int gh = wh0 + 8 * j + 2 * q + (e & 1);
        if (gv < V && gh < H) from_f32(acc[i][j][e], dW + (size_t)gv * H + gh);
      }
  if (blockIdx.z == 0 && tid < DBN && col0 + tid < V) db[col0 + tid] = db_acc;
}

template <typename T, bool STREAM>
cudaError_t launch_grid(const T* h, const T* W, const T* b, const float* lse,
                        const float* g_lse, const float* g_label,
                        const float* g_sum, const int* labels, int rows, int H,
                        int V, T* dW, float* db, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(H, STREAM);
  cudaError_t err = cudaFuncSetAttribute(
      xent_dw_tc_kernel<T, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((V + DBN - 1) / DBN, DSPLIT, (H + DHP - 1) / DHP);
  xent_dw_tc_kernel<T, STREAM><<<grid, DTHREADS, bytes, st>>>(
      h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H, V, tile_ld<T>(H),
      dW, db);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* lse,
           const void* g_lse, const void* g_label, const void* g_sum,
           const void* labels, int rows, int H, int V, void* dW, void* db,
           void* stream) {
  // the resident tiles where they fit, else the ring
  auto run = smem_bytes<T>(H, false) <= MAX_SMEM ? launch_grid<T, false>
                                                  : launch_grid<T, true>;
  return static_cast<int>(
      run(static_cast<const T*>(h), static_cast<const T*>(W),
          static_cast<const T*>(b), static_cast<const float*>(lse),
          static_cast<const float*>(g_lse),
          static_cast<const float*>(g_label),
          static_cast<const float*>(g_sum), static_cast<const int*>(labels),
          rows, H, V, static_cast<T*>(dW), static_cast<float*>(db),
          static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// h [rows, H], W [V, H], b [V] or null, all float32; lse, g_lse, g_label,
// g_sum [rows] f32; labels [rows] int32; outputs dW [V, H] float32, db [V]
// f32. No scratch.
int care_xent_bwd_dw_f32(const void* h, const void* W, const void* b,
                         const void* lse, const void* g_lse,
                         const void* g_label, const void* g_sum,
                         const void* labels, int rows, int H, int V, void* dW,
                         void* db, void* stream) {
  return launch<float>(h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H,
                       V, dW, db, stream);
}

// the same with h, W, b and dW in bfloat16 (db stays f32)
int care_xent_bwd_dw_bf16(const void* h, const void* W, const void* b,
                          const void* lse, const void* g_lse,
                          const void* g_label, const void* g_sum,
                          const void* labels, int rows, int H, int V,
                          void* dW, void* db, void* stream) {
  return launch<__nv_bfloat16>(h, W, b, lse, g_lse, g_label, g_sum, labels,
                               rows, H, V, dW, db, stream);
}

}  // extern "C"
