// Native evaluation core: the O(n*m) inner loops of caption scoring.
//
// The reference's only native evaluation code is pycocoevalcap's Java METEOR
// jar + Java PTBTokenizer (reference misc/cocoeval.py:4-9). This module is
// the C++ equivalent for our stack: batched longest-common-subsequence
// (ROUGE-L) and greedy METEOR-style unigram alignment, the two quadratic
// host-side loops that dominate corpus scoring. Exposed through a plain C
// ABI consumed via ctypes (care_tpu_torch/native/__init__.py); the pure-python
// implementations remain as fallback.
//
// Built on first use by care_tpu_torch/native/__init__.py with the host
// C++ compiler into care_tpu_torch/build/ (libcare_eval.so)

#include <array>
#include <cstdint>
#include <cstring>
#include <vector>
#include <algorithm>

extern "C" {

// Longest common subsequence length of two int32 token-id sequences.
int32_t lcs_len(const int32_t* a, int32_t na, const int32_t* b, int32_t nb) {
  if (na <= 0 || nb <= 0) return 0;
  std::vector<int32_t> prev(nb + 1, 0), cur(nb + 1, 0);
  for (int32_t i = 1; i <= na; ++i) {
    const int32_t ai = a[i - 1];
    for (int32_t j = 1; j <= nb; ++j) {
      cur[j] = (ai == b[j - 1]) ? prev[j - 1] + 1
                                : std::max(cur[j - 1], prev[j]);
    }
    std::swap(prev, cur);
  }
  return prev[nb];
}

// Batched LCS: for one hypothesis vs n_refs references (flattened with
// per-ref lengths), writes per-ref LCS lengths into `out`.
void lcs_len_multi(const int32_t* hyp, int32_t n_hyp,
                   const int32_t* refs_flat, const int32_t* ref_lens,
                   int32_t n_refs, int32_t* out) {
  int32_t offset = 0;
  for (int32_t r = 0; r < n_refs; ++r) {
    out[r] = lcs_len(hyp, n_hyp, refs_flat + offset, ref_lens[r]);
    offset += ref_lens[r];
  }
}

// METEOR-1.5 jar-style alignment over two id views of the same token
// sequences (module 0 = exact ids, module 1 = stem ids; per-pair module
// priority follows the jar's module order, exact before stem).  Joint
// beam-search resolution exactly like the jar's Aligner: among candidate
// one-to-one alignments prefer (1) more matched words, (2) fewer chunks,
// (3) smaller summed |hyp_idx - ref_idx| distance; partial alignments are
// expanded hypothesis-word by hypothesis-word under a width-40 beam.
// Semantics identical to the python `_align` in care_tpu_torch/metrics/meteor.py.
// Writes (hyp_idx, ref_idx, module) triples into match_out (size >=
// 3*n_hyp) and returns the number of matches; returns -1 when n_ref > 64
// (used-reference bitmask width) so the caller falls back to python.
namespace {
struct Partial {
  int32_t matches = 0, chunks = 0, dist = 0;
  int32_t last_h = -2, last_r = -2;
  uint64_t used = 0;
  std::vector<std::array<int32_t, 3>> ml;
  bool better_than(const Partial& o) const {
    if (matches != o.matches) return matches > o.matches;
    if (chunks != o.chunks) return chunks < o.chunks;
    return dist < o.dist;
  }
};
constexpr int kBeam = 40;
}  // namespace

int32_t meteor_align(const int32_t* hyp_exact, const int32_t* hyp_stem,
                     int32_t n_hyp,
                     const int32_t* ref_exact, const int32_t* ref_stem,
                     int32_t n_ref,
                     int32_t* match_out) {
  if (n_ref > 64) return -1;
  std::vector<Partial> beams(1);
  std::vector<Partial> next;
  for (int32_t i = 0; i < n_hyp; ++i) {
    next.clear();
    for (const Partial& p : beams) {
      next.push_back(p);  // hypothesis word i left unmatched
      for (int32_t j = 0; j < n_ref; ++j) {
        if (p.used >> j & 1) continue;
        int32_t module;
        if (hyp_exact[i] == ref_exact[j]) {
          module = 0;
        } else if (hyp_stem != nullptr && ref_stem != nullptr &&
                   hyp_stem[i] == ref_stem[j]) {
          module = 1;
        } else {
          continue;
        }
        Partial q = p;
        q.matches += 1;
        q.chunks += (p.last_h == i - 1 && p.last_r == j - 1) ? 0 : 1;
        q.dist += (i > j) ? (i - j) : (j - i);
        q.last_h = i;
        q.last_r = j;
        q.used |= (uint64_t{1} << j);
        q.ml.push_back({i, j, module});
        next.push_back(std::move(q));
      }
    }
    // stable: partials tying on (matches, chunks, dist) must keep
    // insertion order exactly like the python aligner's list.sort, or the
    // two implementations pick different winners at the beam cutoff
    std::stable_sort(next.begin(), next.end(),
                     [](const Partial& a, const Partial& b) {
                       return a.better_than(b);
                     });
    if (static_cast<int>(next.size()) > kBeam) next.resize(kBeam);
    std::swap(beams, next);
  }
  const Partial& best = beams.front();
  for (size_t k = 0; k < best.ml.size(); ++k) {
    match_out[3 * k] = best.ml[k][0];
    match_out[3 * k + 1] = best.ml[k][1];
    match_out[3 * k + 2] = best.ml[k][2];
  }
  return static_cast<int32_t>(best.ml.size());
}

}  // extern "C"
