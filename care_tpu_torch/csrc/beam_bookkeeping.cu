// The beam step's reorder and finished bookkeeping, in one launch.
//
// Replaces no TPU kernel. On the TPU the beam loop is one `lax.while_loop`
// that XLA compiles whole (care_tpu/decoding/beam_search.py), so the step's
// integer bookkeeping fuses there for free. On the card each of its torch
// ops is a kernel of its own: on an H100 a replayed flagship step (batch 64,
// beam 5) ran 178.5 kernels, 2-3 us each with its gap, and 71.4 with this
// one in their place; they moved a few hundred int64 values.
// This kernel does all of it after the head's top-k, for one step `t`:
//   prev_k  = best_ids // V, new_tok = best_ids - prev_k * V
//   last_tokens = new_tok, row_idx[n*K + k] = n*K + prev_k (the carry's
//   gather), scores = best_scores;
//   tokens[n, k] = tokens[n, prev_k], with tokens[n, k, t] = new_tok;
//   EOS rows enter the finished buffer in beam order: slot = fin_count +
//   (the EOS rows before k), admitted while slot < Fb; an admitted row
//   writes fin_scores = its score, fin_lengths = t, fin_tokens =
//   tokens[n, k, 1:L] ++ [0]; fin_count = min(fin_count + admitted, Fb).
// Every value is a copy or integer arithmetic, so the result is bit for bit
// that of the plain version (care_tpu_torch/ops/beam_bookkeeping.py).
//
// What bounds it: a launch. At the serve shape (N = 64, K = 5, L = 30) it
// moves about 2 x 77 KB of history and a few KB more, under a microsecond
// of the card's bandwidth.
//
// Design. One block per instance n: beams never leave their instance, so a
// block owns all it reads and writes, and the history is reordered in place.
// Warp 0 holds one beam per lane (K <= 32): it computes prev_k and new_tok,
// writes the per-beam outputs, finds each EOS row's place among the
// instance's EOS rows with a ballot and a popcount, writes the admitted
// rows' score and length, and lane 0 the new count. Then all threads walk
// the history in passes of COLS columns: each pass reads the K reordered
// rows into shared memory, synchronises and writes them back, and an
// admitted row's copy, shifted left by one, into its slot of fin_tokens.
// Columns are independent, so a pass may write what the next does not read.
// Only admitted rows write the finished buffer (their slots are distinct);
// the torch loop's other rows write back what they read. One owner per
// output, no atomics; shared memory is fixed, so any N and L are taken.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (care_tpu_torch/ops/_build.py). Plain C entry
// point, loaded with ctypes; every pointer and the stream are passed as
// void*. It launches on the given stream, does not synchronise, allocates
// nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int MAX_K = 32;     // one warp's lanes
constexpr int THREADS = 128;
constexpr int COLS = 64;      // history columns a pass through shared memory

typedef long long i64;

__global__ void __launch_bounds__(THREADS) beam_bookkeeping_kernel(
    const float* __restrict__ best_scores, i64 scores_ld,
    const i64* __restrict__ best_ids, i64 ids_ld, int K, int L, int Fb, i64 V,
    int t, i64 eos_id, i64* tokens, float* __restrict__ scores,
    i64* __restrict__ last_tokens, float* __restrict__ fin_scores,
    i64* __restrict__ fin_lengths, i64* __restrict__ fin_tokens,
    i64* __restrict__ fin_count, i64* __restrict__ row_idx) {
  __shared__ i64 hist[MAX_K][COLS];
  __shared__ i64 new_tok[MAX_K];
  __shared__ int src[MAX_K];   // the beam a row continues
  __shared__ int slot[MAX_K];  // an admitted row's finished slot, else -1
  const i64 n = blockIdx.x;
  const int tid = threadIdx.x;

  if (tid < 32) {
    const int k = tid;
    const bool beam = k < K;
    bool is_eos = false;
    float score = 0.f;
    if (beam) {
      const i64 id = best_ids[n * ids_ld + k];
      // floor division, as torch.div(rounding_mode="floor")
      i64 pk = id / V;
      if (id % V != 0 && (id < 0) != (V < 0)) --pk;
      const i64 tok = id - pk * V;
      score = best_scores[n * scores_ld + k];
      last_tokens[n * K + k] = tok;
      scores[n * K + k] = score;
      // an index outside the instance reaches the carry's gather, which
      // refuses it; this block reads a row of its own
      row_idx[n * K + k] = n * K + pk;
      src[k] = static_cast<int>(pk < 0 ? 0 : (pk >= K ? K - 1 : pk));
      new_tok[k] = tok;
      is_eos = tok == eos_id;
    }
    const i64 count = fin_count[n];
    const unsigned eos = __ballot_sync(0xffffffffu, is_eos);
    const i64 s = count + __popc(eos & ((1u << k) - 1u));
    const bool admit = is_eos && s < Fb;
    const unsigned admitted = __ballot_sync(0xffffffffu, admit);
    if (beam) {
      slot[k] = admit ? static_cast<int>(s) : -1;
      if (admit) {
        fin_scores[n * Fb + s] = score;
        fin_lengths[n * Fb + s] = t;
      }
    }
    if (k == 0) {
      const i64 c = count + __popc(admitted);
      fin_count[n] = c < Fb ? c : Fb;
    }
  }
  __syncthreads();

  i64* hist_n = tokens + n * K * L;
  for (int c0 = 0; c0 < L; c0 += COLS) {
    const int w = min(COLS, L - c0);
    for (int i = tid; i < K * w; i += THREADS) {
      const int k = i / w, c = i - k * w;
      hist[k][c] = c0 + c == t ? new_tok[k]
                               : hist_n[(i64)src[k] * L + c0 + c];
    }
    __syncthreads();
    for (int i = tid; i < K * w; i += THREADS) {
      const int k = i / w, c = i - k * w, col = c0 + c;
      const i64 v = hist[k][c];
      hist_n[(i64)k * L + col] = v;
      // the generated words: positions 1..L-1 of the history (BOS left out)
      if (slot[k] >= 0 && col > 0)
        fin_tokens[(n * Fb + slot[k]) * L + col - 1] = v;
    }
    __syncthreads();
  }
  if (tid < K && slot[tid] >= 0)
    fin_tokens[(n * Fb + slot[tid]) * L + L - 1] = 0;
}

}  // namespace

extern "C" {

// the largest beam a call takes (one warp's lanes)
int care_beam_bookkeeping_max_k() { return MAX_K; }

// best_scores [N, K] f32 and best_ids [N, K] int64, rows `*_ld` elements
// apart, each row contiguous; the state, contiguous and updated in place:
// tokens [N, K, L] int64, scores [N, K] f32, last_tokens [N, K] int64,
// fin_scores [N, Fb] f32, fin_lengths [N, Fb] int64, fin_tokens [N, Fb, L]
// int64, fin_count [N] int64; out: row_idx [N * K] int64. 1 <= t < L,
// 1 <= K <= min(MAX_K, Fb).
int care_beam_bookkeeping(const void* best_scores, long long scores_ld,
                          const void* best_ids, long long ids_ld, int N,
                          int K, int L, int Fb, long long V, int t,
                          long long eos_id, void* tokens, void* scores,
                          void* last_tokens, void* fin_scores,
                          void* fin_lengths, void* fin_tokens,
                          void* fin_count, void* row_idx, void* stream) {
  if (N < 1 || K < 1 || K > MAX_K || Fb < K || L < 2 || t < 1 || t >= L ||
      V < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  beam_bookkeeping_kernel<<<N, THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(best_scores), scores_ld,
      static_cast<const i64*>(best_ids), ids_ld, K, L, Fb, V, t, eos_id,
      static_cast<i64*>(tokens), static_cast<float*>(scores),
      static_cast<i64*>(last_tokens), static_cast<float*>(fin_scores),
      static_cast<i64*>(fin_lengths), static_cast<i64*>(fin_tokens),
      static_cast<i64*>(fin_count), static_cast<i64*>(row_idx));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
