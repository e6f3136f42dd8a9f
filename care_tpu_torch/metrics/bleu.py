"""Corpus BLEU with the COCO 'closest' effective-reference-length option.

Port of ``care_tpu/metrics/bleu.py``.

Pure-python reimplementation of the algorithm used by pycocoevalcap's
``Bleu`` scorer (the reference consumes it via ``misc/cocoeval.py:67-73``):
clipped modified n-gram precision accumulated corpus-wide, brevity penalty
against the closest reference length, geometric mean up to n=4, with the
same ``tiny``/``small`` smoothing constants.
"""

import math
from collections import defaultdict


def _ngram_counts(tokens, n_max=4):
    counts = defaultdict(int)
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


def compute_bleu(gts: dict, res: dict, n_max: int = 4):
    """gts/res: dict[id] -> list of tokenized caption strings
    (res has exactly one). Returns (list of corpus Bleu_1..n, per-image)."""
    small = 1e-9
    tiny = 1e-15

    total_comps = {"testlen": 0, "reflen": 0,
                   "guess": [0] * n_max, "correct": [0] * n_max}
    per_image = [[] for _ in range(n_max)]

    for vid in gts:
        hyp = res[vid][0].split()
        refs = [r.split() for r in gts[vid]]

        testlen = len(hyp)
        # closest reference length (ties -> shorter, like coco cook_refs)
        reflen = min((abs(len(r) - testlen), len(r)) for r in refs)[1]

        ref_counts = defaultdict(int)
        for r in refs:
            for ng, c in _ngram_counts(r, n_max).items():
                ref_counts[ng] = max(ref_counts[ng], c)
        hyp_counts = _ngram_counts(hyp, n_max)

        guess = [max(0, testlen - n) for n in range(n_max)]
        correct = [0] * n_max
        for ng, c in hyp_counts.items():
            correct[len(ng) - 1] += min(c, ref_counts.get(ng, 0))

        total_comps["testlen"] += testlen
        total_comps["reflen"] += reflen
        for n in range(n_max):
            total_comps["guess"][n] += guess[n]
            total_comps["correct"][n] += correct[n]

        # per-image score (with +1 smoothing on counts, like coco verbose=0
        # path which computes them but only corpus scores are used)
        img_bleus = []
        logb = 0.0
        for n in range(n_max):
            logb += math.log(correct[n] + tiny) - math.log(guess[n] + small)
            b = math.exp(logb / (n + 1))
            if testlen < reflen:
                b *= math.exp(1 - reflen / (testlen + tiny))
            img_bleus.append(b)
        for n in range(n_max):
            per_image[n].append(img_bleus[n])

    bleus = []
    logb = 0.0
    testlen, reflen = total_comps["testlen"], total_comps["reflen"]
    for n in range(n_max):
        logb += (math.log(total_comps["correct"][n] + tiny)
                 - math.log(total_comps["guess"][n] + small))
        b = math.exp(logb / (n + 1))
        if testlen < reflen:
            b *= math.exp(1 - reflen / (testlen + tiny))
        bleus.append(b)
    return bleus, per_image
