"""CIDEr (Consensus-based Image Description Evaluation).

Port of ``care_tpu/metrics/cider.py``.

Pure-python reimplementation of the pycocoevalcap ``Cider`` scorer
algorithm (the reference's model-selection metric, ``misc/cocoeval.py`` +
``opts.py:196``): tf-idf vectors over n-grams (n=1..4) with document
frequency computed from the *reference* corpus, per-n cosine similarity
with the length-difference gaussian penalty (sigma=6), averaged over n and
scaled by 10.
"""

import math
from collections import defaultdict

import numpy as np


def _ngrams(tokens, n_max=4):
    counts = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def compute_cider(gts: dict, res: dict, n_max: int = 4, sigma: float = 6.0):
    """gts/res: dict[id] -> list of tokenized caption strings."""
    # document frequency over reference sets
    doc_freq = defaultdict(int)
    ref_counts = {}
    hyp_counts = {}
    for vid in gts:
        refs = [_ngrams(r.split(), n_max) for r in gts[vid]]
        ref_counts[vid] = refs
        hyp_counts[vid] = _ngrams(res[vid][0].split(), n_max)
        for ng in set(ng for ref in refs for ng in ref):
            doc_freq[ng] += 1

    log_ref_len = math.log(max(len(gts), 1e-12))

    def tfidf_vec(counts):
        vec = [defaultdict(float) for _ in range(n_max)]
        norm = [0.0] * n_max
        length = 0
        for ng, c in counts.items():
            df = math.log(max(doc_freq.get(ng, 0), 1.0))
            n = len(ng) - 1
            vec[n][ng] = float(c) * (log_ref_len - df)
            norm[n] += vec[n][ng] ** 2
            if n == 0:
                length += c
        norm = [math.sqrt(x) for x in norm]
        return vec, norm, length

    def sim(vh, nh, lh, vr, nr, lr):
        delta = float(lh - lr)
        val = np.zeros(n_max)
        for n in range(n_max):
            # min-clipped dot product (coco clips the hyp count to the ref's)
            s = 0.0
            for ng, w in vh[n].items():
                s += min(w, vr[n].get(ng, 0.0)) * vr[n].get(ng, 0.0)
            if nh[n] != 0 and nr[n] != 0:
                val[n] = s / (nh[n] * nr[n])
            val[n] *= math.exp(-(delta ** 2) / (2 * sigma ** 2))
        return val

    scores = []
    for vid in gts:
        vh, nh, lh = tfidf_vec(hyp_counts[vid])
        score = np.zeros(n_max)
        for ref in ref_counts[vid]:
            vr, nr, lr = tfidf_vec(ref)
            score += sim(vh, nh, lh, vr, nr, lr)
        score_avg = np.mean(score / max(len(ref_counts[vid]), 1))
        scores.append(score_avg * 10.0)

    mean = float(np.mean(scores)) if scores else 0.0
    return mean, scores
