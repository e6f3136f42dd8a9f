"""METEOR: python METEOR-1.5 scorer + optional exact-parity jar mode.

Port of ``care_tpu/metrics/meteor.py``.

The reference scores METEOR through the pycocoevalcap Java jar
(``misc/cocoeval.py:4-9``), i.e. METEOR 1.5 with ``-l en -norm``.  Two
paths here:

* **jar mode (bit-exact)** — when ``CARE_METEOR_JAR`` points to a local
  ``meteor-1.5.jar`` and ``java`` is on PATH, scoring goes through the same
  ``-stdio`` protocol pycocoevalcap uses, so numbers match the reference
  exactly.  (Zero-egress environments without the jar fall through.)
* **python fallback** — a METEOR-1.5-semantics implementation:
  English parameters (alpha=0.85, beta=0.2, gamma=0.6, delta=0.75), module
  weights (exact=1.0, stem=0.6, synonym=0.8), content/function-word delta
  weighting, per-segment best-reference selection, and the jar's
  corpus-level aggregation (one score from summed sufficient statistics,
  NOT the mean of segment scores).

The aligner reproduces the jar's joint beam-search resolution (all
modules' candidates resolved together: maximise matched words, then
minimise chunks, then minimise summed position distance, width-40 beam —
Aligner.java semantics), with a native C++ fast path
(``care_tpu_torch/native/eval_core.cc:meteor_align``) kept in lockstep.

Known deviations of the fallback from the jar (documented in PARITY.md),
now data-only: the synonym stage needs local WordNet data (skipped
otherwise) and the paraphrase-table stage is absent (its data ships
inside the jar; the curated ``FUNCTION_WORDS`` stands in for the jar's
``function.words``).  CIDEr (the model-selection metric) is exact either
way.
"""

import os
import shutil
import subprocess
from typing import List

try:
    from nltk.stem.porter import PorterStemmer
    _STEMMER = PorterStemmer()
except Exception:  # pragma: no cover
    _STEMMER = None

# METEOR 1.5 English parameters (Denkowski & Lavie 2014, table 2)
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
STAGE_WEIGHTS = (1.0, 0.6, 0.8)  # exact, stem, synonym

# curated stand-in for the jar's function.words list (common closed-class
# English words); content words get weight DELTA, function words 1-DELTA
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no all both few many
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
is am are was were be been being do does did done doing have has had
having will would shall should may might can could must
of in on at by for with about against between into through during before
after above below to from up down out off over under again further
and or but nor so yet if because as until while when where why how what
which who whom whose there here then than too very just not only own same
s t don ve ll re m d
""".split())

_WORDNET = None


def _get_wordnet():
    global _WORDNET
    if _WORDNET is None:
        try:
            from nltk.corpus import wordnet
            wordnet.synsets("dog")  # probe local data
            _WORDNET = wordnet
        except Exception:
            _WORDNET = False
    return _WORDNET or None


def _synonyms(word):
    wn = _get_wordnet()
    if wn is None:
        return set()
    syns = set()
    try:
        for s in wn.synsets(word):
            for l in s.lemmas():
                syns.add(l.name().lower())
    except Exception:
        return set()
    return syns


# ---------------------------------------------------------------------------
# alignment (exact -> stem -> synonym stages, one-to-one)
# ---------------------------------------------------------------------------

def _align_native(hyp: List[str], ref: List[str]):
    """C++ fast path (exact + stem stages only, same semantics as the
    python loop below); None when the native lib is absent or a synonym
    stage would be needed (WordNet data present)."""
    if _get_wordnet() is not None:
        return None
    try:
        from care_tpu_torch import native
        if not native.available():
            return None
        interned = {}
        he = [interned.setdefault(t, len(interned)) for t in hyp]
        re_ = [interned.setdefault(t, len(interned)) for t in ref]
        if _STEMMER is not None:
            hs = [interned.setdefault(_STEMMER.stem(t), len(interned))
                  for t in hyp]
            rs = [interned.setdefault(_STEMMER.stem(t), len(interned))
                  for t in ref]
        else:
            hs, rs = he, re_
        return native.meteor_align(he, hs, re_, rs)
    except Exception:
        return None


# beam width of the jar's Aligner partial-alignment search
_BEAM = 40


def _candidate_matches(hyp: List[str], ref: List[str]):
    """cands[i] = [(ref_idx, module)] with per-pair module priority in the
    jar's module order: exact (0) before stem (1) before synonym (2)."""
    ref_stems = ([_STEMMER.stem(w) for w in ref]
                 if _STEMMER is not None else None)
    wn = _get_wordnet() is not None
    ref_syns = [_synonyms(w) for w in ref] if wn else None
    cands = []
    for i, hw in enumerate(hyp):
        hw_stem = _STEMMER.stem(hw) if _STEMMER is not None else None
        hw_syns = _synonyms(hw) if wn else None
        row = []
        for j, rw in enumerate(ref):
            if hw == rw:
                row.append((j, 0))
            elif hw_stem is not None and hw_stem == ref_stems[j]:
                row.append((j, 1))
            elif wn and (hw in ref_syns[j] or rw in hw_syns):
                row.append((j, 2))
        cands.append(row)
    return cands


def _resolve_beam(cands, n_hyp: int):
    """The jar Aligner's joint resolution: choose a one-to-one alignment
    maximising matched words, then minimising chunks, then minimising
    summed |hyp_idx - ref_idx|; partial alignments expand hypothesis-word
    by hypothesis-word under a width-``_BEAM`` beam.

    Partial state: (matches, chunks, dist, last_h, last_r, used_ref_mask,
    match_tuple)."""
    beams = [(0, 0, 0, -2, -2, 0, ())]
    for i in range(n_hyp):
        nxt = list(beams)  # each partial may leave word i unmatched
        for m, ch, d, lh, lr, used, ml in beams:
            for j, module in cands[i]:
                if used >> j & 1:
                    continue
                nxt.append((
                    m + 1,
                    ch + (0 if (lh == i - 1 and lr == j - 1) else 1),
                    d + abs(i - j), i, j, used | (1 << j),
                    ml + ((i, j, module),)))
        nxt.sort(key=lambda p: (-p[0], p[1], p[2]))
        beams = nxt[:_BEAM]
    return list(beams[0][6])


def _align(hyp: List[str], ref: List[str]):
    """METEOR-1.5 jar alignment; returns [(hyp_idx, ref_idx, module)].
    All modules' candidate matches are resolved JOINTLY by the Aligner
    beam search (max matches -> min chunks -> min distance), matching the
    jar — not stage-sequentially."""
    native_matches = _align_native(hyp, ref)
    if native_matches is not None:
        return native_matches
    return _resolve_beam(_candidate_matches(hyp, ref), len(hyp))


def _chunks(matches):
    if not matches:
        return 0
    ms = sorted((h, r) for h, r, _ in matches)
    chunks = 1
    for (h0, r0), (h1, r1) in zip(ms, ms[1:]):
        if not (h1 == h0 + 1 and r1 == r0 + 1):
            chunks += 1
    return chunks


def _weighted_len(words: List[str]) -> float:
    return sum(DELTA if w not in FUNCTION_WORDS else 1.0 - DELTA
               for w in words)


class _Stats:
    """Sufficient statistics of one (hyp, ref) pair — the jar's
    MeteorStats: aggregation is plain summation."""
    __slots__ = ("w_match_h", "w_match_r", "w_len_h", "w_len_r",
                 "matches", "chunks")

    def __init__(self, w_match_h=0.0, w_match_r=0.0, w_len_h=0.0,
                 w_len_r=0.0, matches=0, chunks=0):
        self.w_match_h, self.w_match_r = w_match_h, w_match_r
        self.w_len_h, self.w_len_r = w_len_h, w_len_r
        self.matches, self.chunks = matches, chunks

    def add(self, o: "_Stats"):
        self.w_match_h += o.w_match_h
        self.w_match_r += o.w_match_r
        self.w_len_h += o.w_len_h
        self.w_len_r += o.w_len_r
        self.matches += o.matches
        self.chunks += o.chunks

    def score(self) -> float:
        if self.matches == 0 or self.w_len_h == 0 or self.w_len_r == 0:
            return 0.0
        p = self.w_match_h / self.w_len_h
        r = self.w_match_r / self.w_len_r
        if p == 0 or r == 0:
            return 0.0
        fmean = p * r / (ALPHA * p + (1.0 - ALPHA) * r)
        frag = self.chunks / float(self.matches)
        pen = GAMMA * (frag ** BETA)
        return fmean * (1.0 - pen)


def _pair_stats(hyp: List[str], ref: List[str]) -> _Stats:
    matches = _align(hyp, ref)
    st = _Stats(w_len_h=_weighted_len(hyp), w_len_r=_weighted_len(ref),
                matches=len(matches), chunks=_chunks(matches))
    for h, r, stage_id in matches:
        w = STAGE_WEIGHTS[stage_id]
        st.w_match_h += w * (DELTA if hyp[h] not in FUNCTION_WORDS
                             else 1.0 - DELTA)
        st.w_match_r += w * (DELTA if ref[r] not in FUNCTION_WORDS
                             else 1.0 - DELTA)
    return st


# ---------------------------------------------------------------------------
# jar mode (exact pycocoevalcap protocol)
# ---------------------------------------------------------------------------

def jar_available() -> bool:
    return bool(os.environ.get("CARE_METEOR_JAR")) \
        and shutil.which("java") is not None


def _compute_meteor_jar(gts: dict, res: dict):
    """pycocoevalcap ``Meteor`` wrapper protocol: one SCORE line per
    segment, then a single EVAL line; per-segment scores stream back,
    the final corpus score is the last line."""
    jar = os.environ["CARE_METEOR_JAR"]
    proc = subprocess.Popen(
        ["java", "-jar", "-Xmx2G", jar, "-", "-", "-stdio", "-l", "en",
         "-norm"],
        cwd=os.path.dirname(os.path.abspath(jar)) or ".",
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    ids = list(gts.keys())
    eval_line = "EVAL"
    for vid in ids:
        refs = [r.replace("|||", "").replace("  ", " ") for r in gts[vid]]
        hyp = res[vid][0].replace("|||", "").replace("  ", " ")
        proc.stdin.write("SCORE ||| " + " ||| ".join(refs + [hyp]) + "\n")
        proc.stdin.flush()
        eval_line += " ||| " + proc.stdout.readline().strip()
    proc.stdin.write(eval_line + "\n")
    proc.stdin.flush()
    scores = [float(proc.stdout.readline().strip()) for _ in ids]
    final = float(proc.stdout.readline().strip())
    proc.stdin.close()
    proc.wait()
    return final, scores


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def compute_meteor(gts: dict, res: dict):
    """gts: {id: [ref strings]}, res: {id: [hyp string]} ->
    (corpus score, per-segment scores)."""
    if jar_available():
        return _compute_meteor_jar(gts, res)

    seg_scores = []
    total = _Stats()
    for vid in gts:
        hyp = res[vid][0].split()
        best = max((_pair_stats(hyp, r.split()) for r in gts[vid]),
                   key=lambda s: s.score())
        seg_scores.append(best.score())
        total.add(best)
    return total.score(), seg_scores
