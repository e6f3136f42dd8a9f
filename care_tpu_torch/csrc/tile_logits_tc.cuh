// Tensor-core building blocks of the four vocab kernels (fused_head_topk.cu,
// vocab_argmax_lse.cu, fused_xent_bwd_dh.cu, fused_xent_bwd_dw.cu) and the
// two flash-attention backward kernels (flash_attention_bwd_dq.cu,
// flash_attention_bwd_dkv.cu): asynchronous staging of K-major tiles into
// shared memory, warp-level products of those tiles on the tensor cores,
// chunk_logits, the one depth-chunk order in which K2, K3a and K3b form a
// logit, and the pieces of the flash products (tiles split once into TF32
// planes, A operands taken from accumulators, B operands read down the
// columns of a row-major tile). tile_logits.cuh keeps the helpers shared
// with the attention kernels (types, rounding, the (value, id) ranking,
// the online-softmax merge).
//
// Numerics. f32 operands stay f32 at every interface and go through the
// tensor cores as three TF32 products accumulated in f32 ("3xTF32"): each
// operand x is split into hi = tf32_rn(x) and lo = tf32_rn(x - hi)
// (rounding to nearest, ties away, as cvt.rna.tf32.f32), and a product a*b is taken as lo_a*hi_b + hi_a*lo_b +
// hi_a*hi_b, the small terms first. The dropped lo*lo term and the roundings
// leave about 2^-21 relative per product, the accuracy of an f32 product on
// the CUDA cores (one TF32 product alone keeps 2^-11 and misses the kernels'
// tolerances; tests/test_torch_tf32_split.py emulates both). bf16 operands
// take one bf16 product with f32 accumulation.
//
// Accumulation. Inside one mma the tensor cores add the products to the
// accumulator with truncation, to the precision of the larger addend, so
// an accumulator that is large against what it gathers (a dW entry that
// adds and cancels label terms over 1856 rows) drifts by up to an ulp of
// its largest value per instruction: 7e-7 in dW at the training shape
// (chip_smoke.py's check), more than the kernels' tolerance. The kernels therefore run each
// short stretch of mma (a depth slice of the logits, a depth step of dW)
// from a zero accumulator and add it to the running sums with an f32 add,
// which rounds to nearest.
//
// Route. mma.sync (m16n8k8 TF32, m16n8k16 bf16), not wgmma: TF32 wgmma reads
// B from shared memory as it lies there, so the hi/lo split of B would need
// two split copies of every tile in shared memory (or a split pass over it),
// while mma.sync takes both operands from registers, where the split is
// three instructions per value. Tiles come in through cp.async (16 bytes a
// thread, zero-filled past the edges) into multi-stage rings, so loads
// overlap the products.
//
// Equal columns give bit-equal logits: a column's logit is the same
// sequence of mma instructions over the same k-steps in the same order,
// whatever tile, warp or position within the n8 fragment it lands in.
//
// Fragment layouts (PTX ISA, mma.m16n8k8 .tf32 and mma.m16n8k16 .bf16, row.col):
// with g = lane / 4 and q = lane % 4,
//   A (16 x k, row-major):  tf32 a0 (g, q) a1 (g+8, q) a2 (g, q+4) a3 (g+8, q+4)
//                           bf16 pairs at columns 2q, 2q+1 and 2q+8, 2q+9
//   B (k x 8, "col"):       tf32 b0 (q, g) b1 (q+4, g)
//                           bf16 pairs at rows 2q, 2q+1 and 2q+8, 2q+9
//   C (16 x 8):             c0 (g, 2q) c1 (g, 2q+1) c2 (g+8, 2q) c3 (g+8, 2q+1)

#pragma once

#include "tile_logits.cuh"

namespace care {
namespace tc {

// ---------------------------------------------------------------------------
// asynchronous copies
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// 4 bytes (cp.async.ca: the .cg form takes only 16), zero-filled when
// src_bytes is 0
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}

// wait until at most n groups are pending; n is clipped to 7, which only
// waits longer
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n < 0 ? 0 : n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::); break;
  }
}

// Stage src[r0 + r][k0 + e] (row stride ld elements) for r < n_rows,
// e < width into dst[r * dst_ld + e], both in elements of T. Rows >= r_end
// and columns >= k_end read as zero. width * sizeof(T) is a multiple of 16
// and dst rows start 16-byte aligned. Pieces of 16 bytes go through
// cp.async (zero-filled past k_end); a piece wholly outside the operand, or
// whose source is not 16-byte aligned (an H that is not a multiple of 16
// bytes), is stored by the thread itself, which the caller's __syncthreads
// makes visible like the asynchronous ones.
//
// A tile that lies wholly inside the operand, with 16-byte aligned rows,
// takes a lean path (the same copies): each thread keeps one column piece
// and steps down the rows by pointer increments, with no bounds checks.
template <typename T>
__device__ __forceinline__ void stage_rows(T* dst, int dst_ld,
                                           const T* __restrict__ src, int ld,
                                           int r0, int r_end, int n_rows,
                                           int k0, int k_end, int width,
                                           int tid, int n_threads) {
  constexpr int PER = 16 / sizeof(T);
  const int pieces = width / PER;
  const T* base = src + (size_t)r0 * ld + k0;
  if (r0 + n_rows <= r_end && k0 + width <= k_end &&
      (ld * sizeof(T)) % 16 == 0 &&
      (reinterpret_cast<size_t>(base) & 15) == 0 && n_threads % pieces == 0) {
    const int p = tid % pieces, step = n_threads / pieces;
    const T* s = base + (size_t)(tid / pieces) * ld + p * PER;
    T* d = dst + (tid / pieces) * dst_ld + p * PER;
    for (int r = tid / pieces; r < n_rows; r += step) {
      cp_async16(d, s, 16);
      s += (size_t)step * ld;
      d += step * dst_ld;
    }
    return;
  }
  for (int idx = tid; idx < n_rows * pieces; idx += n_threads) {
    const int r = idx / pieces, p = idx % pieces;
    const int gr = r0 + r, gk = k0 + p * PER;
    T* d = dst + (size_t)r * dst_ld + p * PER;
    const int valid = gr < r_end ? min(PER, max(0, k_end - gk)) : 0;
    const T* s = src + (size_t)(valid > 0 ? gr : 0) * ld + (valid > 0 ? gk : 0);
    if (valid > 0 && (reinterpret_cast<size_t>(s) & 15) == 0) {
      cp_async16(d, s, valid * (int)sizeof(T));
    } else {
#pragma unroll
      for (int e = 0; e < PER; ++e) d[e] = e < valid ? s[e] : T(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// tensor-core products
// ---------------------------------------------------------------------------

// x rounded to TF32, to nearest with ties away from zero, on the bits:
// what cvt.rna.tf32.f32 gives for finite x, in two full-rate integer
// instructions (the conversion instruction runs at a fraction of the rate)
__device__ __forceinline__ unsigned tf32_rn(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo, both TF32
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = tf32_rn(x);
  lo = tf32_rn(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An A fragment (16 x k) ready for the tensor cores: hi and lo for f32
// operands (3xTF32), the bf16 pairs for bf16 ones.
template <typename T> struct FragA;
template <> struct FragA<float> { unsigned hi[4], lo[4]; };
template <> struct FragA<__nv_bfloat16> { unsigned v[4]; };
template <typename T> struct FragB;
template <> struct FragB<float> { unsigned hi[2], lo[2]; };
template <> struct FragB<__nv_bfloat16> { unsigned v[2]; };

// depth of one mma step in elements of T
template <typename T> struct Kstep;
template <> struct Kstep<float> { static constexpr int value = 8; };
template <> struct Kstep<__nv_bfloat16> { static constexpr int value = 16; };

__device__ __forceinline__ unsigned pack_bf16(__nv_bfloat16 lo_k,
                                              __nv_bfloat16 hi_k) {
  return static_cast<unsigned>(__bfloat16_as_ushort(lo_k)) |
         (static_cast<unsigned>(__bfloat16_as_ushort(hi_k)) << 16);
}

// A = s^T for a row-major f32 tile s[k][m] (the fragment's k runs down the
// rows of s) at (m0, k0); values are rounded to T (they already are)
template <typename T>
__device__ __forceinline__ void load_a_transposed(FragA<T>& f, const float* s,
                                                  int ld, int m0, int k0,
                                                  int lane);
template <>
__device__ __forceinline__ void load_a_transposed(FragA<float>& f,
                                                  const float* s, int ld,
                                                  int m0, int k0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (size_t)(k0 + q) * ld + m0 + g;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[8], f.hi[1], f.lo[1]);
  split_tf32(p[4 * ld], f.hi[2], f.lo[2]);
  split_tf32(p[4 * ld + 8], f.hi[3], f.lo[3]);
}
template <>
__device__ __forceinline__ void load_a_transposed(FragA<__nv_bfloat16>& f,
                                                  const float* s, int ld,
                                                  int m0, int k0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (size_t)(k0 + 2 * q) * ld + m0 + g;
  auto b = [](float x) { return __float2bfloat16_rn(x); };
  f.v[0] = pack_bf16(b(p[0]), b(p[ld]));
  f.v[1] = pack_bf16(b(p[8]), b(p[ld + 8]));
  f.v[2] = pack_bf16(b(p[8 * ld]), b(p[9 * ld]));
  f.v[3] = pack_bf16(b(p[8 * ld + 8]), b(p[9 * ld + 8]));
}

// B from a tile stored k-major, s[k][n] with n contiguous (rows of h read
// as the reduced axis), at (k0, n0)
__device__ __forceinline__ void load_b_kmajor(FragB<float>& f, const float* s,
                                              int ld, int k0, int n0,
                                              int lane) {
  const int g = lane >> 2, q = lane & 3;
  const float* p = s + (size_t)(k0 + q) * ld + n0 + g;
  split_tf32(p[0], f.hi[0], f.lo[0]);
  split_tf32(p[4 * ld], f.hi[1], f.lo[1]);
}
__device__ __forceinline__ void load_b_kmajor(FragB<__nv_bfloat16>& f,
                                              const __nv_bfloat16* s, int ld,
                                              int k0, int n0, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const __nv_bfloat16* p = s + (size_t)(k0 + 2 * q) * ld + n0 + g;
  f.v[0] = pack_bf16(p[0], p[ld]);
  f.v[1] = pack_bf16(p[8 * ld], p[9 * ld]);
}

// ldmatrix: four (x4) or two (x2) 8 x 8 matrices of 16-bit pairs, lane l
// giving the address of row l % 8 of matrix l / 8; thread t receives word
// t % 4 of row t / 4 of each. A 32-bit f32 element is one such word.
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}
__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(s));
}

__device__ __forceinline__ void to_frag(FragA<float>& f, const unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), f.hi[i], f.lo[i]);
}
__device__ __forceinline__ void to_frag(FragA<__nv_bfloat16>& f,
                                        const unsigned (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f.v[i] = r[i];
}
__device__ __forceinline__ void to_frag(FragB<float>& f, unsigned r0,
                                        unsigned r1) {
  split_tf32(__uint_as_float(r0), f.hi[0], f.lo[0]);
  split_tf32(__uint_as_float(r1), f.hi[1], f.lo[1]);
}
__device__ __forceinline__ void to_frag(FragB<__nv_bfloat16>& f, unsigned r0,
                                        unsigned r1) {
  f.v[0] = r0;
  f.v[1] = r1;
}

// The A fragment at (m0, k0) of a row-major tile s[m][k] through one
// ldmatrix.x4; rows start 16-byte aligned and k0 is a multiple of the step
template <typename T>
__device__ __forceinline__ void ldsm_a(FragA<T>& f, const T* s, int ld,
                                       int m0, int k0, int lane) {
  const int mat = lane >> 3, row = lane & 7;
  unsigned r[4];
  ldsm_x4(r, s + (size_t)(m0 + row + (mat & 1) * 8) * ld + k0 +
                 (mat >> 1) * (16 / (int)sizeof(T)));
  to_frag(f, r);
}

// The B fragments of the n8 tiles at n0 and n0 + 8 of an n-major tile
// s[n][k] through one ldmatrix.x4
template <typename T>
__device__ __forceinline__ void ldsm_b2(FragB<T>& f0, FragB<T>& f1,
                                        const T* s, int ld, int n0, int k0,
                                        int lane) {
  const int mat = lane >> 3, row = lane & 7;
  unsigned r[4];
  ldsm_x4(r, s + (size_t)(n0 + row + (mat >> 1) * 8) * ld + k0 +
                 (mat & 1) * (16 / (int)sizeof(T)));
  to_frag(f0, r[0], r[1]);
  to_frag(f1, r[2], r[3]);
}

// one n8 tile's B fragment through ldmatrix.x2 (lanes 0-15 give addresses)
template <typename T>
__device__ __forceinline__ void ldsm_b1(FragB<T>& f, const T* s, int ld,
                                        int n0, int k0, int lane) {
  const int mat = (lane >> 3) & 1, row = lane & 7;
  unsigned r[2];
  ldsm_x2(r, s + (size_t)(n0 + row) * ld + k0 + mat * (16 / (int)sizeof(T)));
  to_frag(f, r[0], r[1]);
}

// c += a * b on the tensor cores: 3xTF32 for f32, one bf16 product for bf16
__device__ __forceinline__ void mma(float (&c)[4], const FragA<float>& a,
                                    const FragB<float>& b) {
  mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}
__device__ __forceinline__ void mma(float (&c)[4],
                                    const FragA<__nv_bfloat16>& a,
                                    const FragB<__nv_bfloat16>& b) {
  mma_bf16(c, a.v, b.v[0], b.v[1]);
}

// ---------------------------------------------------------------------------
// the logits of one depth chunk
// ---------------------------------------------------------------------------

// Depth of the chunks in which K2, K3a and K3b form the logits.
constexpr int LOGIT_CHUNK = 64;

// x[j] += the product over one LOGIT_CHUNK-deep chunk of the A tile
// (row-major, rows m0.. of As, k contiguous) and the n-major B tile (columns
// n0 + 8j.. of Bs, k contiguous), both starting at the chunk's first k. The
// chunk's mma steps run from zero in four accumulator sets (step s into set
// s % 4, so that 4 * NF independent mma chains are in flight) and are added
// to x as (p0 + p1) + (p2 + p3) with f32 adds ("Accumulation" above). K2
// (vocab_argmax_lse.cu), K3a (fused_xent_bwd_dh.cu) and K3b
// (fused_xent_bwd_dw.cu) form every logit through this function, chunk
// after chunk in increasing depth from x = 0, so a column's logit is
// bit-identical in the forward's lse and in both backward recomputations.
template <typename T, int NF>
__device__ __forceinline__ void chunk_logits(float (&x)[NF][4], const T* As,
                                             int lda, int m0, const T* Bs,
                                             int ldb, int n0, int lane) {
  static_assert(NF % 2 == 0, "B fragments come in pairs");
  constexpr int KS = Kstep<T>::value;
  float part[4][NF][4];
#pragma unroll
  for (int p = 0; p < 4; ++p)
#pragma unroll
    for (int j = 0; j < NF; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[p][j][e] = 0.f;
#pragma unroll
  for (int s = 0; s < LOGIT_CHUNK / KS; ++s) {
    FragA<T> a;
    ldsm_a(a, As, lda, m0, s * KS, lane);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      FragB<T> f0, f1;
      ldsm_b2(f0, f1, Bs, ldb, n0 + 8 * j, s * KS, lane);
      mma(part[s % 4][j], a, f0);
      mma(part[s % 4][j + 1], a, f1);
    }
  }
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      x[j][e] += (part[0][j][e] + part[1][j][e]) +
                 (part[2][j][e] + part[3][j][e]);
}

// ---------------------------------------------------------------------------
// the flash backward products
// ---------------------------------------------------------------------------
//
// The two flash backward kernels multiply three kinds of operand:
//   * a resident row-major tile [m][k] (Q and dO in the dq kernel, K and V in
//     the dk/dv kernel) as A, through ldsm_a, split per warp as it is read;
//   * a streamed row-major tile [n][k] (K and V, or Q and dO) as B of the
//     score-shaped products, and the same tile as B [k][n] of the products
//     that accumulate the gradients (g k, p^T do, g^T q): read down its
//     columns. An f32 tile is split once, after it lands, into TF32 planes
//     (split_in_place: hi over the values, lo in a second plane), so that
//     the warps that all read it split nothing; a bf16 tile is read as it is
//     (ldmatrix .trans for the column reads);
//   * p or g, held in mma accumulators, as A (acc_to_a): for bf16 two
//     adjacent n8 accumulator fragments, packed in pairs, are an A fragment
//     of m16n8k16. For TF32 m16n8k8 they are not: the accumulator holds
//     columns (2q, 2q+1), the A fragment wants (q, q+4). The depth index is
//     permuted instead: A slot q takes column 2q and slot q + 4 column
//     2q + 1, and B is read at depth rows (2q, 2q + 1) to match (load_b_cols).
//     Each depth row still meets its own column once; no shuffle and no
//     trip through shared memory.

// A streamed tile as the products read it: f32 as TF32 hi and lo planes of
// one pitch, bf16 as it lies
template <typename T> struct Planes;
template <> struct Planes<float> { const float* hi; const float* lo; int ld; };
template <> struct Planes<__nv_bfloat16> {
  const __nv_bfloat16* v;
  int ld;
};

// x[r * LD + c] for r < ROWS, c < WIDTH split in place for the tensor cores:
// x keeps hi = tf32_rn(x), lo[r * LD + c] gets tf32_rn(x - hi). Rows start
// 16-byte aligned and WIDTH is a multiple of 4.
template <int ROWS, int WIDTH, int LD, int NT>
__device__ __forceinline__ void split_in_place(float* x, float* lo, int tid) {
  constexpr int C4 = WIDTH / 4;
  for (int i = tid; i < ROWS * C4; i += NT) {
    const int off = (i / C4) * LD + 4 * (i % C4);
    const float4 v = *reinterpret_cast<const float4*>(x + off);
    uint4 h, l;
    split_tf32(v.x, h.x, l.x);
    split_tf32(v.y, h.y, l.y);
    split_tf32(v.z, h.z, l.z);
    split_tf32(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(x + off) = h;
    *reinterpret_cast<uint4*>(lo + off) = l;
  }
}

__device__ __forceinline__ void ldsm_x4_trans(unsigned (&r)[4],
                                              const void* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s));
}

// The B fragments of the n8 tiles at n0 and n0 + 8 of an n-major tile
// [n][k] (rows n, depth contiguous), as ldsm_b2 reads them
__device__ __forceinline__ void ldsm_b2(FragB<float>& f0, FragB<float>& f1,
                                        const Planes<float>& t, int n0, int k0,
                                        int lane) {
  const int mat = lane >> 3, row = lane & 7;
  const int at = (n0 + row + (mat >> 1) * 8) * t.ld + k0 + (mat & 1) * 4;
  unsigned r[4];
  ldsm_x4(r, t.hi + at);
  f0.hi[0] = r[0]; f0.hi[1] = r[1]; f1.hi[0] = r[2]; f1.hi[1] = r[3];
  ldsm_x4(r, t.lo + at);
  f0.lo[0] = r[0]; f0.lo[1] = r[1]; f1.lo[0] = r[2]; f1.lo[1] = r[3];
}
__device__ __forceinline__ void ldsm_b2(FragB<__nv_bfloat16>& f0,
                                        FragB<__nv_bfloat16>& f1,
                                        const Planes<__nv_bfloat16>& t,
                                        int n0, int k0, int lane) {
  ldsm_b2(f0, f1, t.v, t.ld, n0, k0, lane);
}

// The B fragments of the n8 tiles at n0 and n0 + 8 of a tile read down its
// columns: depth k runs down the rows of [k][n]. TF32: depth rows k0 + 2q
// and k0 + 2q + 1 (the permuted depth of acc_to_a), scalar loads, which
// fall on 32 distinct banks when the pitch is 4 modulo 16; bf16: the
// fragment's own rows through ldmatrix .trans.
__device__ __forceinline__ void load_b_cols(FragB<float>& f0, FragB<float>& f1,
                                            const Planes<float>& t, int k0,
                                            int n0, int lane) {
  const int at = (k0 + 2 * (lane & 3)) * t.ld + n0 + (lane >> 2);
  const float* hi = t.hi + at;
  const float* lo = t.lo + at;
  f0.hi[0] = __float_as_uint(hi[0]);
  f0.hi[1] = __float_as_uint(hi[t.ld]);
  f1.hi[0] = __float_as_uint(hi[8]);
  f1.hi[1] = __float_as_uint(hi[t.ld + 8]);
  f0.lo[0] = __float_as_uint(lo[0]);
  f0.lo[1] = __float_as_uint(lo[t.ld]);
  f1.lo[0] = __float_as_uint(lo[8]);
  f1.lo[1] = __float_as_uint(lo[t.ld + 8]);
}
__device__ __forceinline__ void load_b_cols(FragB<__nv_bfloat16>& f0,
                                            FragB<__nv_bfloat16>& f1,
                                            const Planes<__nv_bfloat16>& t,
                                            int k0, int n0, int lane) {
  // matrix m of ldmatrix: depth rows k0 + (m & 1) * 8.., columns
  // n0 + (m >> 1) * 8..
  const int mat = lane >> 3, row = lane & 7;
  unsigned r[4];
  ldsm_x4_trans(r, t.v + (size_t)(k0 + row + (mat & 1) * 8) * t.ld + n0 +
                       (mat >> 1) * 8);
  f0.v[0] = r[0]; f0.v[1] = r[1]; f1.v[0] = r[2]; f1.v[1] = r[3];
}

// The A fragment of depth step kk of a 16 x 8NF tile held in accumulators
// (c[j]: columns 8j..8j+7), rounded to T
template <int NF>
__device__ __forceinline__ void acc_to_a(FragA<float>& a,
                                         const float (&c)[NF][4], int kk) {
  split_tf32(c[kk][0], a.hi[0], a.lo[0]);   // (g, 2q)      -> slot (g, q)
  split_tf32(c[kk][2], a.hi[1], a.lo[1]);   // (g + 8, 2q)  -> (g + 8, q)
  split_tf32(c[kk][1], a.hi[2], a.lo[2]);   // (g, 2q + 1)  -> (g, q + 4)
  split_tf32(c[kk][3], a.hi[3], a.lo[3]);   // (g + 8, 2q + 1)
}
template <int NF>
__device__ __forceinline__ void acc_to_a(FragA<__nv_bfloat16>& a,
                                         const float (&c)[NF][4], int kk) {
  auto b = [](float x) { return __float2bfloat16_rn(x); };
  a.v[0] = pack_bf16(b(c[2 * kk][0]), b(c[2 * kk][1]));
  a.v[1] = pack_bf16(b(c[2 * kk][2]), b(c[2 * kk][3]));
  a.v[2] = pack_bf16(b(c[2 * kk + 1][0]), b(c[2 * kk + 1][1]));
  a.v[3] = pack_bf16(b(c[2 * kk + 1][2]), b(c[2 * kk + 1][3]));
}

// The two score-shaped products of a flash backward tile, from zero over
// the whole depth DEPTH: x = A1 B1^T and y = A2 B2^T, A1, A2 rows m0..m0+15
// of resident row-major tiles (pitch lda), B1, B2 streamed n-major tiles,
// 8NF columns. The two products interleave, 2NF independent mma chains.
template <typename T, int NF, int DEPTH>
__device__ __forceinline__ void score_pair(float (&x)[NF][4],
                                           float (&y)[NF][4], const T* A1,
                                           const T* A2, int lda, int m0,
                                           const Planes<T>& B1,
                                           const Planes<T>& B2, int lane) {
  static_assert(NF % 2 == 0, "B fragments come in pairs");
  constexpr int KS = Kstep<T>::value;
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DEPTH; k0 += KS) {
    FragA<T> a1, a2;
    ldsm_a(a1, A1, lda, m0, k0, lane);
    ldsm_a(a2, A2, lda, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      FragB<T> f0, f1, h0, h1;
      ldsm_b2(f0, f1, B1, 8 * j, k0, lane);
      ldsm_b2(h0, h1, B2, 8 * j, k0, lane);
      mma(x[j], a1, f0);
      mma(x[j + 1], a1, f1);
      mma(y[j], a2, h0);
      mma(y[j + 1], a2, h1);
    }
  }
}

// The A fragment at (m0, k0) of a resident row-major tile held as planes:
// f32 split once into TF32 hi and lo (two ldmatrix, no split per read),
// bf16 as it lies
__device__ __forceinline__ void ldsm_a(FragA<float>& f, const Planes<float>& t,
                                       int m0, int k0, int lane) {
  const int mat = lane >> 3, row = lane & 7;
  const int at = (m0 + row + (mat & 1) * 8) * t.ld + k0 + (mat >> 1) * 4;
  ldsm_x4(f.hi, t.hi + at);
  ldsm_x4(f.lo, t.lo + at);
}
__device__ __forceinline__ void ldsm_a(FragA<__nv_bfloat16>& f,
                                       const Planes<__nv_bfloat16>& t, int m0,
                                       int k0, int lane) {
  ldsm_a(f, t.v, t.ld, m0, k0, lane);
}

// x = A B^T from zero over the whole depth DEPTH: A rows m0..m0+15 of a
// resident tile held as planes, B a streamed n-major tile of 8NF columns
// (the flash forward's scores)
template <typename T, int NF, int DEPTH>
__device__ __forceinline__ void score_tile(float (&x)[NF][4],
                                           const Planes<T>& A, int m0,
                                           const Planes<T>& B, int lane) {
  static_assert(NF % 2 == 0, "B fragments come in pairs");
  constexpr int KS = Kstep<T>::value;
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int k0 = 0; k0 < DEPTH; k0 += KS) {
    FragA<T> a;
    ldsm_a(a, A, m0, k0, lane);
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      FragB<T> f0, f1;
      ldsm_b2(f0, f1, B, 8 * j, k0, lane);
      mma(x[j], a, f0);
      mma(x[j + 1], a, f1);
    }
  }
}

// Rows m0..m0+15 of a resident row-major f32 tile split for the tensor
// cores by the warp that reads them: the lo halves of its A fragments over
// the depth DEPTH into registers, hi = tf32_rn(x) back in place (the rows'
// elements, each written by the lane that holds it)
template <int DEPTH>
__device__ __forceinline__ void split_rows_a(unsigned (&lo)[DEPTH / 8][4],
                                             float* s, int ld, int m0,
                                             int lane) {
  const int mat = lane >> 3, row = lane & 7;
  float* own = s + (m0 + (lane >> 2)) * ld + (lane & 3);
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks) {
    unsigned r[4], hi[4];
    ldsm_x4(r, s + (m0 + row + (mat & 1) * 8) * ld + ks * 8 + (mat >> 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) split_tf32(__uint_as_float(r[i]), hi[i], lo[ks][i]);
    // fragment word i: row g + 8 (i & 1), column q + 4 (i >> 1)
    own[ks * 8] = __uint_as_float(hi[0]);
    own[8 * ld + ks * 8] = __uint_as_float(hi[1]);
    own[ks * 8 + 4] = __uint_as_float(hi[2]);
    own[8 * ld + ks * 8 + 4] = __uint_as_float(hi[3]);
  }
  __syncwarp();
}

// score_tile for f32 with A split by split_rows_a: hi read from the tile,
// lo from registers
template <int NF, int DEPTH>
__device__ __forceinline__ void score_tile(float (&x)[NF][4],
                                           const float* A_hi, int ld, int m0,
                                           const unsigned (&a_lo)[DEPTH / 8][4],
                                           const Planes<float>& B, int lane) {
  static_assert(NF % 2 == 0, "B fragments come in pairs");
  const int mat = lane >> 3, row = lane & 7;
#pragma unroll
  for (int j = 0; j < NF; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < DEPTH / 8; ++ks) {
    FragA<float> a;
    ldsm_x4(a.hi, A_hi + (m0 + row + (mat & 1) * 8) * ld + ks * 8 +
                      (mat >> 1) * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) a.lo[i] = a_lo[ks][i];
#pragma unroll
    for (int j = 0; j < NF; j += 2) {
      FragB<float> f0, f1;
      ldsm_b2(f0, f1, B, 8 * j, ks * 8, lane);
      mma(x[j], a, f0);
      mma(x[j + 1], a, f1);
    }
  }
}

// acc[j] += (A: the 16 x 8NK tile held in accumulators c, rounded to T) x
// (B: rows 0..8NK-1 of a streamed tile read down its columns, columns
// 8j..8j+7). Per four n8 blocks the tile's products run from zero and are
// then added to acc with f32 adds, so the accumulators never take the
// tensor cores' truncating adds over more than one tile's depth.
template <typename T, int NK, int NO>
__device__ __forceinline__ void acc_product(float (&acc)[NO][4],
                                            const float (&c)[NK][4],
                                            const Planes<T>& B, int lane) {
  static_assert(NO % 4 == 0, "four n8 blocks at a time");
  constexpr int KS = Kstep<T>::value, STEPS = NK * 8 / KS;
  FragA<T> a[STEPS];
#pragma unroll
  for (int s = 0; s < STEPS; ++s) acc_to_a(a[s], c, s);
#pragma unroll
  for (int j = 0; j < NO; j += 4) {
    float part[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[u][e] = 0.f;
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      FragB<T> f0, f1, f2, f3;
      load_b_cols(f0, f1, B, s * KS, 8 * j, lane);
      load_b_cols(f2, f3, B, s * KS, 8 * j + 16, lane);
      mma(part[0], a[s], f0);
      mma(part[1], a[s], f1);
      mma(part[2], a[s], f2);
      mma(part[3], a[s], f3);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j + u][e] += part[u][e];
  }
}

}  // namespace tc
}  // namespace care
