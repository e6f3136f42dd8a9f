"""ROUGE-L F-measure (beta=1.2), max over references.

Port of ``care_tpu/metrics/rouge.py``.

Pure-python reimplementation of the pycocoevalcap ``Rouge`` scorer algorithm
(consumed by the reference via ``misc/cocoeval.py:67-73``).
"""


def _lcs_len(a, b):
    """Length of the longest common subsequence (O(len(a)*len(b))).

    Uses the native C++ core (care_tpu_torch/native) when built; token
    strings are interned to int ids for the C ABI."""
    if not a or not b:
        return 0
    try:
        from care_tpu_torch import native
        if native.available():
            interned = {}
            ai = [interned.setdefault(t, len(interned)) for t in a]
            bi = [interned.setdefault(t, len(interned)) for t in b]
            r = native.lcs_len(ai, bi)
            if r is not None:
                return r
    except Exception:
        pass
    prev = [0] * (len(b) + 1)
    for i in range(1, len(a) + 1):
        cur = [0] * (len(b) + 1)
        ai = a[i - 1]
        for j in range(1, len(b) + 1):
            if ai == b[j - 1]:
                cur[j] = prev[j - 1] + 1
            else:
                cur[j] = max(cur[j - 1], prev[j])
        prev = cur
    return prev[-1]


def _calc_score(hyp_tokens, ref_token_lists, beta=1.2):
    prec, rec = [], []
    for ref in ref_token_lists:
        lcs = _lcs_len(hyp_tokens, ref)
        prec.append(lcs / len(hyp_tokens) if hyp_tokens else 0.0)
        rec.append(lcs / len(ref) if ref else 0.0)
    prec_max, rec_max = max(prec), max(rec)
    if prec_max != 0 and rec_max != 0:
        return ((1 + beta ** 2) * prec_max * rec_max
                / (rec_max + beta ** 2 * prec_max))
    return 0.0


def compute_rouge(gts: dict, res: dict):
    scores = []
    for vid in gts:
        hyp = res[vid][0].split()
        refs = [r.split() for r in gts[vid]]
        scores.append(_calc_score(hyp, refs))
    mean = sum(scores) / max(len(scores), 1)
    return mean, scores
