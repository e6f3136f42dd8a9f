// Flash attention, forward: softmax(q k^T / sqrt(Dh) + bias) v by key tiles
// with an online softmax, so that the [Lq, Lk] scores never reach device
// memory; also the per-row log-sum-exp that the backward kernels recompute
// the probabilities from.
//
// Replaces the TPU kernel `_flash_fwd_kernel` of
// care_tpu/ops/pallas/flash_attention.py (launched by `_flash_fwd_impl`). For
// q [B, H, Lq, Dh], k and v [B, H, Lk, Dh] (f32 or bf16, contiguous) and an
// optional f32 bias read through its strides over (B, H, Lq, Lk):
//   s   = (q k^T) * Dh^-0.5 + bias           accumulated in f32
//   out = softmax(s) v   [B, H, Lq, Dh], in q's type;   lse [B, H, Lq] f32
// The rules that are part of the function: the running maximum starts at
// -1e9, not -inf; the probabilities are rounded to the input type before the
// second product, which accumulates in f32, while their sum is taken
// unrounded; a row whose sum is 0 gives output 0 and lse 1e9; keys past Lk
// weigh exactly 0.
//
// What bounds it on an H100 SXM (3.35 TB/s; 495 TFLOP/s TF32, 989 bf16 on
// the tensor cores, 67 TFLOP/s f32 on the CUDA cores), f32:
//   decode shape, q [64, 8, 5, 64] against 1654 keys (one launch per decoder
//     layer per beam step of the long-key configuration): K and V are read
//     once, 433.6 MB, 0.130 ms, against 2.17 GFLOP, 0.032 ms on the CUDA
//     cores: bytes. At the ragged batch of 17, 115.2 MB, 0.034 ms;
//   square shape [4, 8, 1568, 64]: 20.1 GFLOP, as three TF32 products
//     (3xTF32, tile_logits_tc.cuh) 0.122 ms, against 51 MB, 0.015 ms:
//     operations.
//
// Design. The TPU kernel carries (max, sum, accumulator) in scratch memory
// across a sequential grid axis over the key blocks. Blocks on the card run
// in no order, so that axis is a loop inside the block. Two variants:
//
// * Large queries (Lq > SMALL_Q): one block owns a (batch * head, 64-row
//   query tile) pair, four warps of 16 rows, every product on the tensor
//   cores through mma.sync (3xTF32 for f32, one m16n8k16 for bf16), the
//   structure of the dq kernel (flash_attention_bwd_dq.cu). Q stays, split
//   once for TF32: as hi/lo planes in shared memory, or (f32 up to head
//   width 64) hi in shared memory and each warp's lo halves in registers,
//   which lets three blocks share an SM; K, V and the bias's key row stream
//   through a cp.async ring, an f32 tile split once into planes after it
//   lands. The scores live in mma accumulators; the online softmax runs on
//   them (a row's maximum from a quad's xor-shuffles, its sum kept per
//   thread and gathered at the end), the output
//   accumulators are rescaled in registers, and p goes straight back as the
//   A operand of p v (acc_to_a: bf16 after rounding, TF32 with the permuted
//   depth, V read down its columns at the matching rows), each tile's p v
//   from zero and added in f32. No score reaches shared memory.
// * Decode (Lq <= SMALL_Q: the beam-grouped step, 5 rows): bytes-bound, so
//   the design is about bytes in flight. One block holds all query rows of
//   one (batch, head) and its four warps take interleaved key tiles, each
//   warp with its own ring of 16-byte cp.async loads and its own
//   (max, sum, accumulator); the warps' states merge in shared memory in
//   warp order. The blocks are small (at most 75 KB; 37 KB at the decode
//   shape in f32), so that three or more share an SM: more warps, each with
//   one tile in flight while it computes another, which on an H100 beat
//   deeper rings in fewer blocks. The products: f32 as exact FMA on the
//   CUDA cores (lanes take a key and a slice of the head width for the
//   scores, then a slice of the head width for p v), bf16 on mma.sync as in
//   the large-query variant, with the query rows padded to an m16 tile:
//   each the faster for its type in kernel_probe's ablation on an H100.
//   Where B * H would leave fewer than
//   SPLIT_BLOCKS_PER_SM blocks an SM, a thread-block cluster of up to
//   MAX_SPLITS blocks splits each (batch, head)'s key tiles into
//   consecutive runs, as far as all blocks stay resident at once (a second
//   wave of blocks costs more than the split gains); the cluster's first
//   block reads the others' merged states through distributed shared
//   memory, in rank order, and writes out and lse. Still one launch, no
//   partial in device memory. The rule of an empty sum is applied once,
//   after the merge; a run with no key (l = 0, max -1e9) weighs nothing.
//
// Every output has one owner and every sum a fixed order: no atomics, and a
// call repeats bit for bit. Ragged edges are bounds checks: query rows past
// Lq are computed on zeros and not stored, keys past Lk score -inf.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// points, loaded with ctypes. Each launches on the given stream, does not
// synchronise, allocates nothing, and returns cudaGetLastError(), -1 for a
// head width it has no instance for, or -2 when a cluster of the chosen
// size cannot be resident on the card.

#include <cooperative_groups.h>

#include <type_traits>

#include "flash_tile.cuh"
#include "tile_logits_tc.cuh"

namespace {

using namespace care_flash;
namespace cg = cooperative_groups;
namespace tc = care::tc;

constexpr unsigned FULL = 0xffffffffu;

// The part of the bias that is read in place: a bias with a query extent
// (relative-position tables). A bias without one is staged a key row a tile
// with the keys' -inf past Lk; `add` then adds nothing.
struct RowBias {
  const float* p;   // the (batch, head)'s bias, or null
  long long sq, sk;
  int last_row, k0, Lk;
  __device__ __forceinline__ void add(float& x, int row, int key) const {
    if (p && k0 + key < Lk) x += p[min(row, last_row) * sq + (k0 + key) * sk];
  }
};

// One key tile of a warp's 16 rows on the tensor cores, after the scores:
// s (mma accumulators; element e of fragment j is row row0 + g + 8 (e / 2),
// key 8j + 2qd + e % 2) is scaled and biased (bt: the staged key row),
// the running maximum m and sum l of rows g and g + 8 move to the tile (a
// row's maximum from a quad's xor-shuffles; l is this thread's share,
// gathered at the end), acc is rescaled in registers, and the weights go
// straight back as the A operand of p v, added to acc from zero.
template <typename T, int NF, int NO>
__device__ __forceinline__ void tile_softmax_pv(
    float (&s)[NF][4], const float* bt, const RowBias& rb, int row0,
    float scale, float (&m)[2], float (&l)[2], float (&acc)[NO][4],
    const tc::Planes<T>& Vp, int lane) {
  const int g = lane >> 2, qd = lane & 3;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = 8 * j + 2 * qd + (e & 1);
      float x = s[j][e] * scale + bt[key];
      rb.add(x, row0 + g + 8 * (e >> 1), key);
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(FULL, mx[half], 1));
    mx[half] = fmaxf(mx[half], __shfl_xor_sync(FULL, mx[half], 2));
    const float m_new = fmaxf(m[half], mx[half]);
    alpha[half] = expf(m[half] - m_new);
    m[half] = m_new;
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = expf(s[j][e] - m[e >> 1]);
      sum[e >> 1] += p;
      s[j][e] = p;
    }
#pragma unroll
  for (int half = 0; half < 2; ++half)
    l[half] = alpha[half] * l[half] + sum[half];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] *= alpha[e >> 1];
  tc::acc_product<T, NF, NO>(acc, s, Vp, lane);
}

// ---------------------------------------------------------------------------
// large queries: 64 query rows a block, on the tensor cores
// ---------------------------------------------------------------------------

template <typename T, int DH>
struct Wide {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int WARPS = 4, BQ = 16 * WARPS, NT = 32 * WARPS;
  // keys per tile: f32 32 (its hi/lo planes and registers), bf16 64
  static constexpr int BKV = F32 ? 32 : 64;
  // f32 up to head width 64: each warp keeps the lo halves of its rows of Q
  // in registers (split_rows_a) and Q's hi in place, and the ring holds two
  // tiles, so that three blocks share an SM (on an H100, 11% faster at the
  // square shape than Q as two planes, a 3-stage ring and two blocks)
  static constexpr bool QREG = F32 && DH <= 64;
  // ring depth: 3, or 2 where a third stage would cost an SM a block
  static constexpr int STAGES = QREG || DH == 128 ? 2 : 3;
  static constexpr int LD = DH + 16 / (int)sizeof(T);   // pitch, elements
  static constexpr int TILE = BKV * LD;                 // one K or V tile
  static constexpr int QTILE = BQ * LD;
  static constexpr size_t BYTES =
      sizeof(T) * ((F32 && !QREG ? 2 : 1) * QTILE + STAGES * 2 * TILE) +
      sizeof(float) * (STAGES * BKV + (F32 ? 2 * TILE : 0));
};

template <typename T, int DH>
__global__ void __launch_bounds__(Wide<T, DH>::NT, Wide<T, DH>::QREG ? 3 : 1)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, BiasRef bias, int H, int Lq, int Lk,
                 float scale, T* __restrict__ out, float* __restrict__ lse) {
  using C = Wide<T, DH>;
  constexpr int BQ = C::BQ, BKV = C::BKV, LD = C::LD, NT = C::NT;
  constexpr int NF = BKV / 8, NO = DH / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* Qs = reinterpret_cast<T*>(smem_raw);   // [BQ][LD]; f32: hi (, lo)
  T* ring = Qs + (C::F32 && !C::QREG ? 2 : 1) * C::QTILE;   // (K, V) tiles
  float* bias_ring = reinterpret_cast<float*>(ring + C::STAGES * 2 * C::TILE);
  float* lo = bias_ring + C::STAGES * BKV;       // f32: K lo, V lo [BKV][LD]

  const int tid = threadIdx.x, lane = tid & 31, m0 = (tid >> 5) * 16;
  const int bh = blockIdx.x, q0 = blockIdx.y * BQ;
  const int b = bh / H, h = bh % H;
  const T* kb = k + (size_t)bh * Lk * DH;
  const T* vb = v + (size_t)bh * Lk * DH;
  const int n_tiles = (Lk + BKV - 1) / BKV;
  // a bias without a query extent is staged a key row a tile; one with a
  // query extent (relative-position tables) is read in place
  const bool bias_rows = bias.p != nullptr && bias.sq != 0;
  const float* bias_bh =
      bias.p ? bias.p + b * bias.sb + h * bias.sh : nullptr;

  tc::stage_rows(Qs, LD, q + (size_t)bh * Lq * DH, DH, q0, Lq, BQ, 0, DH, DH,
                 tid, NT);

  // key tile t into ring slot t % STAGES (one commit group, empty past the
  // last tile; Q joins the first)
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
        else if (bias.p && !bias_rows)
          tc::cp_async4(d, bias_bh + key * bias.sk, 4);
        else
          *d = 0.f;
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < C::STAGES - 1; ++s) load(s);

  const int g = lane >> 2, qd = lane & 3;
  float m_run[2] = {MASKED, MASKED}, l_run[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  tc::Planes<T> Qp;                        // Q as planes, unless QREG
  unsigned qlo[C::QREG ? DH / 8 : 1][4];   // QREG: this warp's lo halves
  if constexpr (!C::F32)
    Qp = {Qs, LD};
  else if constexpr (!C::QREG)
    Qp = {Qs, Qs + C::QTILE, LD};

  for (int t = 0; t < n_tiles; ++t) {
    tc::cp_async_wait(C::STAGES - 2);
    __syncthreads();   // tile t visible; every warp done with tile t - 1
    load(t + C::STAGES - 1);
    const int slot = t % C::STAGES;
    T* Kt = ring + slot * 2 * C::TILE;
    T* Vt = Kt + C::TILE;
    tc::Planes<T> Kp, Vp;
    if constexpr (C::F32) {
      if (t == 0) {
        if constexpr (C::QREG)
          tc::split_rows_a<DH>(qlo, Qs, LD, m0, lane);
        else
          tc::split_in_place<BQ, DH, LD, NT>(Qs, Qs + C::QTILE, tid);
      }
      tc::split_in_place<BKV, DH, LD, NT>(Kt, lo, tid);
      tc::split_in_place<BKV, DH, LD, NT>(Vt, lo + C::TILE, tid);
      __syncthreads();
      Kp = {Kt, lo, LD};
      Vp = {Vt, lo + C::TILE, LD};
    } else {
      Kp = {Kt, LD};
      Vp = {Vt, LD};
    }

    float s[NF][4];
    if constexpr (C::QREG)
      tc::score_tile<NF, DH>(s, Qs, LD, m0, qlo, Kp, lane);
    else
      tc::score_tile<T, NF, DH>(s, Qp, m0, Kp, lane);
    const float* brow = bias_ring + slot * BKV;
    const RowBias rb{bias_rows ? bias_bh : nullptr, bias.sq, bias.sk, Lq - 1,
                     t * BKV, Lk};
    tile_softmax_pv<T>(s, brow, rb, q0 + m0, scale, m_run, l_run, acc, Vp,
                       lane);
  }

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    // the row's sum over the quad; every lane ends with the same value
    float l = l_run[half];
    l += __shfl_xor_sync(FULL, l, 1);
    l += __shfl_xor_sync(FULL, l, 2);
    const int row = q0 + m0 + g + 8 * half;
    if (row >= Lq) continue;
    const float safe = l == 0.f ? 1.f : l;
    T* o = out + ((size_t)bh * Lq + row) * DH + 2 * qd;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      from_f32(acc[j][2 * half] / safe, o + 8 * j);
      from_f32(acc[j][2 * half + 1] / safe, o + 8 * j + 1);
    }
    if (qd == 0)
      lse[(size_t)bh * Lq + row] = l == 0.f ? 1e9f : m_run[half] + logf(l);
  }
}

// ---------------------------------------------------------------------------
// decode: at most SMALL_Q query rows; warps, and a cluster's blocks, split
// the keys
// ---------------------------------------------------------------------------

// at most this many query rows take the decode variant
constexpr int SMALL_Q = 8;
constexpr int DEC_WARPS = 4;
// the key split over a cluster: up to MAX_SPLITS blocks, doubled while
// B * H * splits is below SPLIT_BLOCKS_PER_SM blocks an SM and twice as many
// blocks would still all be resident at once
constexpr int MAX_SPLITS = 8;
constexpr int SPLIT_BLOCKS_PER_SM = 2;
// the decode products: bf16 on mma.sync, f32 as exact FMA on the CUDA cores,
// the faster of the two for each type (kernel_probe's ablation)
template <typename T>
__host__ __device__ constexpr bool decode_on_mma() {
  return sizeof(T) == 2;
}

// One warp's rows on the CUDA cores. For the scores LPK = 32 / TK lanes take
// one key each, lane (kk, part) = (lane % TK, lane / TK) a 1 / LPK slice of
// the head width, the slices added by a butterfly of xor-shuffles; for p v
// each lane owns DH / 32 columns.
template <typename T, int DH, int R, int TK>
struct FmaRows {
  static constexpr int LPK = 32 / TK, DS = DH / LPK, DPL = DH / 32;
  float m[R], l[R], acc[R][DPL];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m[r] = MASKED;
      l[r] = 0.f;
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] = 0.f;
    }
  }

  // One key tile: Q f32 [R][DH], K and V [TK][LD], the staged bias [TK],
  // p [R][TK] in `pbuf`.
  template <int LD>
  __device__ __forceinline__ void tile(const float* Qf, const T* Kt,
                                       const T* Vt, const float* bt,
                                       const RowBias& rb, float scale,
                                       float* pbuf, int lane) {
    const int kk = lane % TK, part = lane / TK;
    float sp[R];
#pragma unroll
    for (int r = 0; r < R; ++r) sp[r] = 0.f;
    const T* krow = Kt + kk * LD + part * DS;
    const float* qs = Qf + part * DS;
#pragma unroll 4
    for (int d = 0; d < DS; d += 4) {
      float kx[4];
      load_f32<4>(krow + d, kx);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        float qx[4];
        load_f32<4>(qs + r * DH + d, qx);
#pragma unroll
        for (int u = 0; u < 4; ++u) sp[r] = fmaf(qx[u], kx[u], sp[r]);
      }
    }
    float alpha[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // a butterfly: every lane of the key ends with the same sum
#pragma unroll
      for (int o = 16; o >= TK; o >>= 1)
        sp[r] += __shfl_xor_sync(FULL, sp[r], o);
      float x = sp[r] * scale + bt[kk];
      rb.add(x, r, kk);
      float mx = x;
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      const float p = expf(x - m_new);
      l[r] = alpha[r] * l[r] + p;
      m[r] = m_new;
      if (part == 0)
        pbuf[r * TK + kk] = round_as(p, static_cast<const T*>(nullptr));
    }
    __syncwarp();
    float pv[R][DPL];
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < DPL; ++j) pv[r][j] = 0.f;
    const T* vcol = Vt + lane * DPL;
#pragma unroll
    for (int c = 0; c < TK; c += 4) {
      float pw[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r) load_f32<4>(pbuf + r * TK + c, pw[r]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float vx[DPL];
        load_f32<DPL>(vcol + (c + u) * LD, vx);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int j = 0; j < DPL; ++j)
            pv[r][j] = fmaf(pw[r][u], vx[j], pv[r][j]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[r][j] = acc[r][j] * alpha[r] + pv[r][j];
    __syncwarp();   // p read before the next tile writes it
  }

  // the warp's (m, l, acc) into shared memory: m, l [R], acc [R][DH]
  __device__ __forceinline__ void finish(float* mw, float* lw, float* accw,
                                         int lane) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      // each lane summed its key's weights: a butterfly over the keys (the
      // slices of a key hold the same), the same value in every lane
      float x = l[r];
#pragma unroll
      for (int o = TK / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
      if (lane == 0) {
        mw[r] = m[r];
        lw[r] = x;
      }
#pragma unroll
      for (int j = 0; j < DPL; ++j) accw[r * DH + lane * DPL + j] = acc[r][j];
    }
  }
};

// One warp's rows on the tensor cores: an m16 tile whose first R rows are
// the queries, the products of the large-query variant.
template <typename T, int DH, int R, int TK>
struct MmaRows {
  static constexpr int NF = TK / 8, NO = DH / 8;
  float m[2], l[2], acc[NO][4];

  __device__ __forceinline__ void init() {
    m[0] = m[1] = MASKED;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  // One key tile: Q as planes [16][LD], K and V [TK][LD] (f32: split here
  // into `lo`), the staged bias [TK].
  template <int LD>
  __device__ __forceinline__ void tile(const tc::Planes<T>& Qp, T* Kt, T* Vt,
                                       const float* bt, const RowBias& rb,
                                       float scale, float* lo, int lane) {
    tc::Planes<T> Kp, Vp;
    if constexpr (sizeof(T) == 4) {
      tc::split_in_place<TK, DH, LD, 32>(Kt, lo, lane);
      tc::split_in_place<TK, DH, LD, 32>(Vt, lo + TK * LD, lane);
      __syncwarp();
      Kp = {Kt, lo, LD};
      Vp = {Vt, lo + TK * LD, LD};
    } else {
      Kp = {Kt, LD};
      Vp = {Vt, LD};
    }
    float s[NF][4];
    tc::score_tile<T, NF, DH>(s, Qp, 0, Kp, lane);
    tile_softmax_pv<T>(s, bt, rb, 0, scale, m, l, acc, Vp, lane);
    __syncwarp();   // the planes read before the next tile is split
  }

  __device__ __forceinline__ void finish(float* mw, float* lw, float* accw,
                                         int lane) {
    const int g = lane >> 2, qd = lane & 3;
    float x = l[0];
    x += __shfl_xor_sync(FULL, x, 1);
    x += __shfl_xor_sync(FULL, x, 2);
    if (g >= R) return;   // rows g >= R and g + 8 are padding
    if (qd == 0) {
      mw[g] = m[0];
      lw[g] = x;
    }
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      accw[g * DH + 8 * j + 2 * qd] = acc[j][0];
      accw[g * DH + 8 * j + 2 * qd + 1] = acc[j][1];
    }
  }
};

template <typename T, int DH, int R>
struct Dec {
  static constexpr bool F32 = sizeof(T) == 4, MMA = decode_on_mma<T>();
  static constexpr int WARPS = DEC_WARPS, NT = 32 * WARPS;
  // keys per warp tile: 16 on mma.sync, 8 on the CUDA cores, in a ring of
  // two: small blocks, so that three or more share an SM (faster on an
  // H100 than deeper rings in fewer blocks, kernel_probe's three_stages)
  static constexpr int TK = MMA ? 16 : 8;
  static constexpr int STAGES = 2;
  static constexpr int LD = DH + 16 / (int)sizeof(T);
  static constexpr int TILE = TK * LD;
  using Rows = std::conditional_t<MMA, MmaRows<T, DH, R, TK>,
                                  FmaRows<T, DH, R, TK>>;
  // Q: f32 [R][DH] (CUDA cores), or the m16 tile as planes (mma)
  static constexpr size_t Q_BYTES =
      MMA ? sizeof(T) * (F32 ? 2 : 1) * 16 * LD : sizeof(float) * R * DH;
  // a warp's own: its ring of K and V tiles and of the staged bias [TK],
  // and p [R][TK] (CUDA cores) or K's and V's lo planes (mma, f32)
  static constexpr size_t WARP_BYTES =
      sizeof(T) * STAGES * 2 * TILE +
      sizeof(float) * (STAGES * TK + (MMA ? (F32 ? 2 * TILE : 0) : R * TK));
  // the merge, over the rings once the loop is done: (m, l, acc) of each
  // warp, then of the block
  static constexpr size_t MERGE_BYTES =
      sizeof(float) * (WARPS + 1) * R * (DH + 2);
  static constexpr size_t BYTES =
      Q_BYTES + (WARPS * WARP_BYTES > MERGE_BYTES ? WARPS * WARP_BYTES
                                                  : MERGE_BYTES);
  static_assert(BYTES <= 227 * 1024, "shared memory");
};

// The (m, l, acc) of n parts of the same rows' keys merged in part order:
// M = max m_c, l = sum l_c exp(m_c - M), acc = sum acc_c exp(m_c - M). A
// part without keys (m = -1e9, l = 0, acc = 0) adds nothing.
// part(c) gives part c's m [R], l [R] and acc [R][DH].
template <int R, int DH, int NT, typename Part>
__device__ __forceinline__ void merge_parts(int n, Part part, float* m,
                                            float* l, float* acc, int tid) {
  for (int i = tid; i < R * (DH + 1); i += NT) {
    const int r = i / (DH + 1), d = i % (DH + 1);   // d == DH: m and l
    float M = part(0).m[r];
    for (int c = 1; c < n; ++c) M = fmaxf(M, part(c).m[r]);
    float x = 0.f;
    for (int c = 0; c < n; ++c) {
      const auto p = part(c);
      x += (d == DH ? p.l[r] : p.acc[r * DH + d]) * expf(p.m[r] - M);
    }
    if (d == DH) {
      m[r] = M;
      l[r] = x;
    } else {
      acc[r * DH + d] = x;
    }
  }
}

struct PartRef {
  const float *m, *l, *acc;
};

template <typename T, int DH, int R>
__global__ void __launch_bounds__(DEC_WARPS * 32)
flash_fwd_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, BiasRef bias, int H, int Lq,
                        int Lk, int splits, float scale, T* __restrict__ out,
                        float* __restrict__ lse) {
  using C = Dec<T, DH, R>;
  constexpr int WARPS = C::WARPS, NT = C::NT, TK = C::TK, LD = C::LD;
  constexpr int STAGES = C::STAGES;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x % splits, bh = blockIdx.x / splits;
  const int b = bh / H, h = bh % H;
  const T* kb = k + (size_t)bh * Lk * DH;
  const T* vb = v + (size_t)bh * Lk * DH;
  // this block's run of key tiles, and this warp's: t_begin + warp,
  // + WARPS, ...
  const int n_tiles = (Lk + TK - 1) / TK;
  const int per = (n_tiles + splits - 1) / splits;
  const int t_begin = min(n_tiles, split * per);
  const int t_end = min(n_tiles, t_begin + per);
  const int mine = max(0, (t_end - t_begin - warp + WARPS - 1) / WARPS);

  unsigned char* work = smem_raw + C::Q_BYTES;
  T* ring = reinterpret_cast<T*>(work + warp * C::WARP_BYTES);
  float* bias_ring = reinterpret_cast<float*>(ring + STAGES * 2 * C::TILE);
  float* scratch = bias_ring + STAGES * TK;
  const bool bias_rows = bias.p != nullptr && bias.sq != 0;
  const float* bias_bh =
      bias.p ? bias.p + b * bias.sb + h * bias.sh : nullptr;

  // the queries: rows past Lq are zeros
  T* Qs = reinterpret_cast<T*>(smem_raw);
  float* Qf = reinterpret_cast<float*>(smem_raw);
  tc::Planes<T> Qp;
  if constexpr (C::MMA) {
    tc::stage_rows(Qs, LD, q + (size_t)bh * Lq * DH, DH, 0, Lq, 16, 0, DH, DH,
                   tid, NT);
    tc::cp_async_commit();
    tc::cp_async_wait(0);
    __syncthreads();
    if constexpr (C::F32) {
      tc::split_in_place<16, DH, LD, NT>(Qs, Qs + 16 * LD, tid);
      Qp = {Qs, Qs + 16 * LD, LD};
    } else {
      Qp = {Qs, LD};
    }
  } else {
    for (int i = tid; i < R * DH; i += NT)
      Qf[i] = i / DH < Lq ? to_f32(q[(size_t)bh * Lq * DH + i]) : 0.f;
  }

  // the warp's i-th tile into its ring slot i % STAGES (one commit group,
  // empty past its last tile)
  auto load = [&](int i) {
    if (i < mine) {
      const int slot = i % STAGES;
      const int k0 = (t_begin + warp + i * WARPS) * TK;
      T* dst = ring + slot * 2 * C::TILE;
      tc::stage_rows(dst, LD, kb, DH, k0, Lk, TK, 0, DH, DH, lane, 32);
      tc::stage_rows(dst + C::TILE, LD, vb, DH, k0, Lk, TK, 0, DH, DH, lane,
                     32);
      if (lane < TK) {
        float* d = bias_ring + slot * TK + lane;
        const int key = k0 + lane;
        if (key >= Lk)
          *d = -INFINITY;
        else if (bias.p && !bias_rows)
          tc::cp_async4(d, bias_bh + key * bias.sk, 4);
        else
          *d = 0.f;
      }
    }
    tc::cp_async_commit();
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) load(s);
  __syncthreads();   // the queries visible to every warp

  typename C::Rows st;
  st.init();
  for (int i = 0; i < mine; ++i) {
    tc::cp_async_wait(STAGES - 2);
    __syncwarp();   // tile i visible to the warp; tile i - 1 read by all
    load(i + STAGES - 1);
    T* Kt = ring + (i % STAGES) * 2 * C::TILE;
    const float* bt = bias_ring + (i % STAGES) * TK;
    const RowBias rb{bias_rows ? bias_bh : nullptr, bias.sq, bias.sk, Lq - 1,
                     (t_begin + warp + i * WARPS) * TK, Lk};
    if constexpr (C::MMA)
      st.template tile<LD>(Qp, Kt, Kt + C::TILE, bt, rb, scale, scratch,
                           lane);
    else
      st.template tile<LD>(Qf, Kt, Kt + C::TILE, bt, rb, scale, scratch,
                           lane);
  }
  tc::cp_async_wait(0);
  __syncthreads();   // every ring done with: the merge lies over them

  float* mw = reinterpret_cast<float*>(work);   // [WARPS][R]
  float* lw = mw + WARPS * R;                   // [WARPS][R]
  float* accw = lw + WARPS * R;                 // [WARPS][R][DH]
  float* mb = accw + WARPS * R * DH;            // the block's: [R]
  float* lb = mb + R;                           // [R]
  float* accb = lb + R;                         // [R][DH]
  st.finish(mw + warp * R, lw + warp * R, accw + warp * R * DH, lane);
  __syncthreads();
  merge_parts<R, DH, NT>(
      WARPS,
      [&](int c) {
        return PartRef{mw + c * R, lw + c * R, accw + c * R * DH};
      },
      mb, lb, accb, tid);
  __syncthreads();

  const float *fm = mb, *fl = lb, *facc = accb;
  if (splits > 1) {
    // the cluster's first block merges every block's state in rank order,
    // read through distributed shared memory, into the warps' area
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (split == 0) {
      merge_parts<R, DH, NT>(
          splits,
          [&](int c) {
            return PartRef{cluster.map_shared_rank(mb, c),
                           cluster.map_shared_rank(lb, c),
                           cluster.map_shared_rank(accb, c)};
          },
          mw, lw, accw, tid);
      fm = mw;
      fl = lw;
      facc = accw;
    }
    __syncthreads();
    cluster.sync();   // no block leaves while the first one reads it
    if (split != 0) return;
  }
  for (int i = tid; i < Lq * DH; i += NT) {
    const float l = fl[i / DH];
    from_f32(facc[i] / (l == 0.f ? 1.f : l), out + (size_t)bh * Lq * DH + i);
  }
  for (int r = tid; r < Lq; r += NT)
    lse[(size_t)bh * Lq + r] = fl[r] == 0.f ? 1e9f : fm[r] + logf(fl[r]);
}

// ---------------------------------------------------------------------------
// launchers
// ---------------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  }
  return n;
}

template <typename T, int DH>
int launch_wide(const void* q, const void* k, const void* v, BiasRef bias,
                int B, int H, int Lq, int Lk, void* out, void* lse,
                cudaStream_t st) {
  using C = Wide<T, DH>;
  auto kernel = flash_fwd_kernel<T, DH>;
  constexpr int bytes = static_cast<int>(C::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(B * H, (Lq + C::BQ - 1) / C::BQ);
  kernel<<<grid, C::NT, bytes, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), bias, H, Lq, Lk, 1.0f / sqrtf((float)DH),
      static_cast<T*>(out), static_cast<float*>(lse));
  return static_cast<int>(cudaGetLastError());
}

// The decode kernel's shared memory set, and how many blocks of it the card
// holds at once (0 if a query fails; the launch then reports the error).
template <typename T, int DH, int R>
int decode_capacity() {
  static int capacity = -1;
  if (capacity < 0) {
    using C = Dec<T, DH, R>;
    auto kernel = flash_fwd_decode_kernel<T, DH, R>;
    int per_sm = 0;
    if (cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(C::BYTES)) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, kernel, C::NT, C::BYTES) != cudaSuccess)
      return 0;
    capacity = per_sm * sm_count();
  }
  return capacity;
}

// how many blocks of a cluster split each (batch, head)'s keys
template <typename T, int DH, int R>
int decode_splits(int B, int H, int Lk) {
  using C = Dec<T, DH, R>;
  const long long pairs = (long long)B * H;
  const long long capacity = decode_capacity<T, DH, R>();
  const int n_tiles = (Lk + C::TK - 1) / C::TK;
  int s = 1;
  // each block keeps at least a tile per warp
  while (s < MAX_SPLITS &&
         pairs * s < (long long)SPLIT_BLOCKS_PER_SM * sm_count() &&
         pairs * 2 * s <= capacity && n_tiles >= 2 * s * C::WARPS)
    s *= 2;
  return s;
}

template <typename T, int DH, int R>
int launch_decode(const void* q, const void* k, const void* v, BiasRef bias,
                  int B, int H, int Lq, int Lk, void* out, void* lse,
                  cudaStream_t st) {
  using C = Dec<T, DH, R>;
  auto kernel = flash_fwd_decode_kernel<T, DH, R>;
  constexpr int bytes = static_cast<int>(C::BYTES);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int splits = decode_splits<T, DH, R>(B, H, Lk);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * H * splits);
  cfg.blockDim = dim3(C::NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = splits;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  // a cluster's blocks must be resident together: checked once per size
  static bool resident[MAX_SPLITS + 1] = {};
  if (splits > 1 && !resident[splits]) {
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, (void*)kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters == 0) return -2;
    resident[splits] = true;
  }
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(q),
                           static_cast<const T*>(k), static_cast<const T*>(v),
                           bias, H, Lq, Lk, splits, 1.0f / sqrtf((float)DH),
                           static_cast<T*>(out), static_cast<float*>(lse));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The rows of a decode block: 2, 5 (the beam of the long-key configuration)
// or 8. `run` is called with an instance of the right size.
template <typename F>
int by_rows(int Lq, F run) {
  if (Lq <= 2) return run(std::integral_constant<int, 2>());
  if (Lq <= 5) return run(std::integral_constant<int, 5>());
  return run(std::integral_constant<int, 8>());
}

template <typename T, int DH>
int launch_dh(const void* q, const void* k, const void* v, BiasRef bias, int B,
              int H, int Lq, int Lk, void* out, void* lse, cudaStream_t st) {
  if (Lq > SMALL_Q)
    return launch_wide<T, DH>(q, k, v, bias, B, H, Lq, Lk, out, lse, st);
  return by_rows(Lq, [&](auto rows) {
    return launch_decode<T, DH, decltype(rows)::value>(q, k, v, bias, B, H, Lq,
                                                       Lk, out, lse, st);
  });
}

template <typename T, int DH>
int splits_dh(int B, int H, int Lq, int Lk) {
  if (Lq > SMALL_Q) return 1;
  return by_rows(Lq, [&](auto rows) {
    return decode_splits<T, DH, decltype(rows)::value>(B, H, Lk);
  });
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* bias,
           long long sb, long long sh, long long sq, long long sk, int B, int H,
           int Lq, int Lk, int Dh, void* out, void* lse, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const BiasRef ref{static_cast<const float*>(bias), sb, sh, sq, sk};
  switch (Dh) {
    case 32: return launch_dh<T, 32>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    case 64: return launch_dh<T, 64>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    case 128:
      return launch_dh<T, 128>(q, k, v, ref, B, H, Lq, Lk, out, lse, st);
    default: return -1;
  }
}

}  // namespace

extern "C" {

// q [B, H, Lq, Dh], k, v [B, H, Lk, Dh] float32, contiguous; bias float32 or
// null, with its strides in elements over (B, H, Lq, Lk), 0 where it
// broadcasts; outputs out [B, H, Lq, Dh] float32 and lse [B, H, Lq] float32.
int care_flash_fwd_f32(const void* q, const void* k, const void* v,
                       const void* bias, long long sb, long long sh,
                       long long sq, long long sk, int B, int H, int Lq, int Lk,
                       int Dh, void* out, void* lse, void* stream) {
  return launch<float>(q, k, v, bias, sb, sh, sq, sk, B, H, Lq, Lk, Dh, out,
                       lse, stream);
}

// the same with q, k, v and out in bfloat16
int care_flash_fwd_bf16(const void* q, const void* k, const void* v,
                        const void* bias, long long sb, long long sh,
                        long long sq, long long sk, int B, int H, int Lq,
                        int Lk, int Dh, void* out, void* lse, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, bias, sb, sh, sq, sk, B, H, Lq, Lk, Dh,
                               out, lse, stream);
}

// how many blocks (one thread-block cluster) the kernels above split each
// (batch, head)'s keys over for this shape; -1 for a head width they have
// no instance for
int care_flash_fwd_key_splits(int B, int H, int Lq, int Lk, int Dh, int bf16) {
  auto pick = [&](auto zero) {
    using T = decltype(zero);
    switch (Dh) {
      case 32: return splits_dh<T, 32>(B, H, Lq, Lk);
      case 64: return splits_dh<T, 64>(B, H, Lq, Lk);
      case 128: return splits_dh<T, 128>(B, H, Lq, Lk);
      default: return -1;
    }
  };
  return bf16 ? pick(__nv_bfloat16()) : pick(0.f);
}

}  // extern "C"
