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
// V 11000) the two products are 4*1856*512*11000 = 41.8 GFLOP. In f32 both
// run as three TF32 tensor-core products (tile_logits_tc.cuh): 125 GFLOP,
// 0.253 ms at the data sheet's 495 TFLOP/s and 0.41 ms at the 306 TFLOP/s
// that mma.sync reaches on an H100 (care_tpu_torch/tools/kernel_probe.py),
// against 30.2 MB (h, W, dh and the row vectors) at 3.35 TB/s, 0.009 ms.
// Bound by operations. In bf16 one product each, 0.042 ms at 989 TFLOP/s.
//
// Design: the ownership of K3b (fused_xent_bwd_dw.cu) mirrored. The TPU
// kernel keeps a [block_rows, H] f32 accumulator in VMEM and walks the vocab
// in order; here a cluster of two blocks owns a row tile of BM = 32 rows,
// and each block walks every other vocab tile of BN = 64 columns:
//   - its h tile [32, H] is staged once into shared memory (cp.async, in
//     64-wide depth chunks, one group each) and stays for the whole walk;
//   - each vocab tile of W [64, H] is staged the same way into one buffer,
//     chunk c by warp c % 8. The logits product takes each depth chunk as
//     soon as its group lands; a warp refills its chunks for the next vocab
//     tile as soon as its own dh product (which reads only those chunks) is
//     done;
//   - the logits tile [32, 64]: each warp owns 16 rows x 16 columns, formed
//     by chunk_logits (tile_logits_tc.cuh): the depth walks in 64-wide
//     chunks, each from zero in four accumulator sets, then added, the
//     order of K3b and of the forward K2, so a column's logit here is
//     bit-identical to the one K2's lse was taken over;
//   - dlogits are formed from the accumulators in registers and written
//     once to shared memory in T (rounded as the TPU kernel rounds them);
//   - dh [32, 512] accumulates in registers across the whole walk: warp w
//     owns H columns [64w, 64w + 64), 2 x 8 fragments, 64 f32 a thread, fed
//     by dlogits (A, ldmatrix) and the staged W tile read k-major (B); each
//     fragment's product over one mma step (8 vocab columns in f32, 16 in
//     bf16) runs from zero and is added to the sums with an f32 add, so the
//     sums round to nearest: the label column's large term of opposite sign
//     cancels against the softmax terms in dh, and truncation inside the
//     accumulator would show over the 11000-long reduction;
//   - at the end the second block of the cluster hands its partial dh to
//     the first through distributed shared memory, which adds it in a fixed
//     order and writes dh.
// No device-memory partials, no reduce pass, no atomics, no scratch: a call
// repeats bit for bit. At the flagship shape the grid is 58 row tiles x 2
// = 116 blocks, one per SM (207 KB of shared memory), one wave.
// Feeding the tensor cores, per warp and mma step in f32: the logits read
// 1024 bytes of shared memory (one ldmatrix.x4 of h, one of W) for 6
// tensor-core instructions, 171 bytes each; the dh product 1024 bytes of
// dlogits (two ldmatrix.x4) and 2048 of W (eight B fragments) for 48, 64
// bytes each. L2 traffic: W is read once per row tile, 58 x 22.5 MB =
// 1.3 GB, and h once, 3.8 MB. Against K3b's logits half without its dW
// product (0.84 ms at this shape, PERF.md), the dh product adds as many
// instructions at 64 bytes each, from registers that K3a does not have to
// refill between row tiles.
// H wider than 512 takes more clusters along the grid's z axis, each owning
// 512 of dh's columns and recomputing the logits. Where h's [32, H] tile and
// W's [64, H] tile do not fit shared memory together (f32 beyond H 576,
// bf16 beyond H 1152: the `median` and `large` presets in f32), the kernel
// streams instead: the logits product takes h's and W's depth chunks
// through a 3-stage cp.async ring, re-reading h's row tile from L2 for every
// vocab tile, and only W's columns of the block's dh slice stay staged for
// the dh product. Every H is taken.
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

constexpr int RBM = 32;             // rows per row tile
constexpr int RBN = 64;             // vocab columns per vocab tile
constexpr int RTHREADS = 256;       // 8 warps
constexpr int RHP = 512;            // dh columns per block: 8 warps x 64
constexpr int KCH = LOGIT_CHUNK;    // depth chunk of the staged tiles
constexpr size_t MAX_SMEM = 232448; // an H100 block's dynamic shared memory
constexpr int VSPLIT = 2;           // blocks of a cluster sharing a row tile
constexpr int NST = 3;              // depth of the streaming variant's ring
// the partial dh [32, 512] a block hands to its cluster's first
constexpr size_t RED_BYTES = (size_t)RBM * RHP * sizeof(float);

// row stride, in elements of T, of the staged h and W tiles: H rounded up
// to whole chunks, plus 16 bytes
template <typename T> int tile_ld(int H) {
  return (H + KCH - 1) / KCH * KCH + 16 / (int)sizeof(T);
}

// the streaming variant's row strides: a ring slot's depth chunk, and W's
// vocab tile over one block's dh columns
template <typename T> __host__ __device__ constexpr int ring_ld() {
  return KCH + 16 / sizeof(T);
}
template <typename T> __host__ __device__ constexpr int slice_ld() {
  return RHP + 16 / sizeof(T);
}
// one ring slot: W's chunk [64, KCH], then h's [32, KCH]
template <typename T> __host__ __device__ constexpr int ring_slot() {
  return (RBN + RBM) * ring_ld<T>();
}
// dlogits [32, 64] in T (16 bytes of padding: ldmatrix without bank
// conflicts)
template <typename T> __host__ __device__ constexpr int ds_ld() {
  return RBN + 16 / sizeof(T);
}

// resident: h's tile [32, H] and W's tile [64, H]; streaming: the ring and
// W's tile over the block's dh columns [64, 512]. Then dlogits; the
// cluster's hand-over reuses the space at the end.
template <typename T> size_t smem_bytes(int H, bool stream) {
  const size_t elems =
      (stream ? (size_t)NST * ring_slot<T>() + (size_t)RBN * slice_ld<T>()
              : (size_t)(RBM + RBN) * tile_ld<T>(H)) +
      (size_t)RBM * ds_ld<T>();
  const size_t tiles = elems * sizeof(T);
  return tiles > RED_BYTES ? tiles : RED_BYTES;
}

template <typename T, bool STREAM>
__global__ void __cluster_dims__(1, VSPLIT, 1) __launch_bounds__(RTHREADS, 1)
xent_dh_tc_kernel(const T* __restrict__ h, const T* __restrict__ W,
                  const T* __restrict__ b, const float* __restrict__ lse,
                  const float* __restrict__ g_lse,
                  const float* __restrict__ g_label,
                  const float* __restrict__ g_sum,
                  const int* __restrict__ labels, int rows, int H, int V,
                  int ld, T* __restrict__ dh) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int KS = Kstep<T>::value;
  constexpr int RLD = ring_ld<T>(), SLOT = ring_slot<T>(), DLD = ds_ld<T>();
  // resident: h's tile (row stride ld), then W's tile; streaming: the
  // ring, then W's tile over this block's dh columns
  T* Hs = reinterpret_cast<T*>(smem);
  T* Ws = Hs + (STREAM ? (size_t)NST * SLOT : (size_t)RBM * ld);
  const int wld = STREAM ? slice_ld<T>() : ld;
  T* Ds = Ws + (size_t)RBN * wld;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, q = lane & 3;
  const int row0 = blockIdx.x * RBM;
  const int hp0 = blockIdx.z * RHP;
  const int nch = (H + KCH - 1) / KCH;
  const int vtiles = (V + RBN - 1) / RBN;
  // the logits fragment of this warp: rows 16 * mi.., columns 16 * ni..
  const int mi = warp & 1, ni = warp >> 1;
  // the dh columns of this warp, and where they lie in the staged W tile
  const int wh0 = hp0 + 64 * warp;
  const int woff = STREAM ? 64 * warp : wh0;

  // streaming: depth chunk c of W's vocab tile at col0 and of h's row tile
  // into ring slot c % NST; every thread commits a group, empty past the end
  auto stage_chunk = [&](int col0, int c) {
    if (c < nch) {
      T* st = Hs + (size_t)(c % NST) * SLOT;
      stage_rows<T>(st, RLD, W, H, col0, V, RBN, c * KCH, H, KCH, tid,
                    RTHREADS);
      stage_rows<T>(st + RBN * RLD, RLD, h, H, row0, rows, RBM, c * KCH, H,
                    KCH, tid, RTHREADS);
    }
    cp_async_commit();
  };

  // Depth chunk c of the staged tiles is loaded by warp c % 8, one
  // cp.async group each: the chunks of dh's columns that a warp owns are
  // the ones it reads in the dh product, so it refills them for the next
  // vocab tile as soon as its own product is done. h's tile comes in with
  // the first vocab tile of W.
  if constexpr (!STREAM)
    for (int c = warp; c < nch; c += 8) {
      stage_rows<T>(Hs + c * KCH, ld, h, H, row0, rows, RBM, c * KCH, H, KCH,
                    lane, 32);
      stage_rows<T>(Ws + c * KCH, ld, W, H, blockIdx.y * RBN, V, RBN,
                    c * KCH, H, KCH, lane, 32);
      cp_async_commit();
    }

  // the row vectors of this thread's two dlogits rows, the same for the
  // whole walk
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

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // this block's vocab tiles: blockIdx.y, blockIdx.y + VSPLIT, ...
  for (int t = blockIdx.y; t < vtiles; t += VSPLIT) {
    const int col0 = t * RBN;
    if constexpr (STREAM) {
      __syncthreads();            // the last vocab tile's dh product is done
      stage_rows<T>(Ws, wld, W, H, col0, V, RBN, hp0, H, RHP, tid, RTHREADS);
      cp_async_commit();
      for (int c = 0; c < NST - 1; ++c) stage_chunk(col0, c);
    }

    // logits [32, 64]: x[n fragment][4], chunk by chunk (chunk_logits)
    float x[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
    for (int c = 0; c < nch; ++c) {
      const T *Hc, *Wc;
      int lc;
      if constexpr (STREAM) {
        cp_async_wait(NST - 2);
        __syncthreads();          // chunk c landed; slot c - 1 is free
        stage_chunk(col0, c + NST - 1);
        Wc = Hs + (size_t)(c % NST) * SLOT;
        Hc = Wc + RBN * RLD;
        lc = RLD;
      } else {
        if (warp == c % 8) cp_async_wait((nch - 1 - c) / 8);
        __syncthreads();
        Hc = Hs + c * KCH;
        Wc = Ws + c * KCH;
        lc = ld;
      }
      chunk_logits<T, 2>(x, Hc, lc, 16 * mi, Wc, lc, 16 * ni, lane);
    }

    // dlogits, rounded to T, into shared memory; 0 outside rows x V
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
        }
        from_f32(d, Ds + r * DLD + c);
      }
    __syncthreads();

    // dh[32, this warp's 64 columns] += dlogits [32, 64] @ W [64, 64]: each
    // fragment's product over one mma step runs from zero and is added to
    // the sums with an f32 add, so that W's fragments are read once and no
    // partial sums need registers beside dh's
    if (wh0 < H) {
#pragma unroll
      for (int s = 0; s < RBN / KS; ++s) {
        FragA<T> a[2];
#pragma unroll
        for (int i = 0; i < 2; ++i) ldsm_a(a[i], Ds, DLD, 16 * i, s * KS, lane);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (wh0 + 8 * j < H) {
            FragB<T> fb;
            load_b_kmajor(fb, Ws, wld, s * KS, woff + 8 * j, lane);
#pragma unroll
            for (int i = 0; i < 2; ++i) {
              float d[4] = {0.f, 0.f, 0.f, 0.f};
              mma(d, a[i], fb);
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[i][j][e] += d[e];
            }
          }
        }
      }
    }

    // this warp's chunks of the next vocab tile of W: no other warp reads
    // them any more (the logits product is behind the last barrier)
    if (!STREAM && t + VSPLIT < vtiles)
      for (int c = warp; c < nch; c += 8) {
        stage_rows<T>(Ws + c * KCH, ld, W, H, col0 + VSPLIT * RBN, V, RBN,
                      c * KCH, H, KCH, lane, 32);
        cp_async_commit();
      }
  }

  // The cluster's blocks summed disjoint vocab tiles: the others hand their
  // partial sums to the first through distributed shared memory (the tiles'
  // space, free now), which adds them in rank order and writes dh.
  cp_async_wait(0);
  __syncthreads();
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  float* red = reinterpret_cast<float*>(smem);
  if (rank != 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          red[((i * 8 + j) * 4 + e) * RTHREADS + tid] = acc[i][j][e];
  }
  cluster.sync();
  if (rank == 0) {
    for (int from = 1; from < VSPLIT; ++from) {
      const float* other = cluster.map_shared_rank(red, from);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] += other[((i * 8 + j) * 4 + e) * RTHREADS + tid];
    }
  }
  // the others' shared memory stays until the first has read it
  cluster.sync();
  if (rank != 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int gr = row0 + 16 * i + g + (e >= 2 ? 8 : 0);
        const int gh = wh0 + 8 * j + 2 * q + (e & 1);
        if (gr < rows && gh < H)
          from_f32(acc[i][j][e], dh + (size_t)gr * H + gh);
      }
}

template <typename T, bool STREAM>
cudaError_t launch_grid(const T* h, const T* W, const T* b, const float* lse,
                        const float* g_lse, const float* g_label,
                        const float* g_sum, const int* labels, int rows, int H,
                        int V, T* dh, cudaStream_t st) {
  const size_t bytes = smem_bytes<T>(H, STREAM);
  cudaError_t err = cudaFuncSetAttribute(
      xent_dh_tc_kernel<T, STREAM>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((rows + RBM - 1) / RBM, VSPLIT, (H + RHP - 1) / RHP);
  xent_dh_tc_kernel<T, STREAM><<<grid, RTHREADS, bytes, st>>>(
      h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H, V, tile_ld<T>(H),
      dh);
  return cudaGetLastError();
}

template <typename T>
int launch(const void* h, const void* W, const void* b, const void* lse,
           const void* g_lse, const void* g_label, const void* g_sum,
           const void* labels, int rows, int H, int V, void* dh,
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
          rows, H, V, static_cast<T*>(dh), static_cast<cudaStream_t>(stream)));
}

}  // namespace

extern "C" {

// h [rows, H], W [V, H], b [V] or null, all float32; lse, g_lse, g_label,
// g_sum [rows] f32; labels [rows] int32; output dh [rows, H] float32. No
// scratch.
int care_xent_bwd_dh_f32(const void* h, const void* W, const void* b,
                         const void* lse, const void* g_lse,
                         const void* g_label, const void* g_sum,
                         const void* labels, int rows, int H, int V, void* dh,
                         void* stream) {
  return launch<float>(h, W, b, lse, g_lse, g_label, g_sum, labels, rows, H,
                       V, dh, stream);
}

// the same with h, W, b and dh in bfloat16
int care_xent_bwd_dh_bf16(const void* h, const void* W, const void* b,
                          const void* lse, const void* g_lse,
                          const void* g_label, const void* g_sum,
                          const void* labels, int rows, int H, int V,
                          void* dh, void* stream) {
  return launch<__nv_bfloat16>(h, W, b, lse, g_lse, g_label, g_sum, labels,
                               rows, H, V, dh, stream);
}

}  // extern "C"
