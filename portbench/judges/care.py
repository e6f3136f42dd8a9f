"""The judge of the CARE configurations (``"judge": "care"``): the
comparisons that decide ``correct``, what the timed path produced held
against the plain reference (``reference/care.py``), and the same numbers
for the control (the reference in a lower precision put in the program's
place). A driver takes from its judge the reference's parameter shapes
(``param_shapes``), its precisions (``precision``) and the comparisons of
its kind (``serve_readings``).

Serving. For each sampled caption the reference encodes the video with the
others of its batch (the batch the program encoded), embeds its concepts,
and runs the decoder's full forward over BOS and the served tokens. Two
numbers:

* ``score_gap``: the served beam score against the reference's
  length-normalised log-probability of the same tokens;
* ``rank_gap``: by how much a served token's reference log-probability lies
  below the reference's ``beam``-th best at its position. A beam keeps
  only candidates within its row's best ``beam``, so a sound decode reads
  rounding; a token altered or chosen wrongly reads far more.

The top concepts are a discrete choice: where two of the reference's
concept probabilities lie within ``TIE`` of each other at the ranks that
decide the choice, each order is tried and the nearest counts, so that a
rounding-level tie does not read as a fault.
"""

import itertools

import torch

from portbench.reference import care

TIE = 1e-6
MAX_TIES = 3

param_shapes = care.param_shapes
precision = care.precision


def concept_variants(preds, k: int) -> list:
    """The reference's top-``k`` concept orders of one video [1, K]: its
    own first, then the orders that swap adjacent concepts whose
    probabilities lie within ``TIE``."""
    vals, order = torch.sort(-preds[0], stable=True)
    vals = -vals[:k + 1]
    close = [i for i in range(k) if float(vals[i] - vals[i + 1]) < TIE]
    close = sorted(close, key=lambda i: float(vals[i] - vals[i + 1]))
    out = []
    for mask in itertools.product((0, 1), repeat=min(len(close),
                                                      MAX_TIES)):
        o = order[:k + 1].clone()
        for i, swap in zip(close, mask):
            if swap:
                o[i], o[i + 1] = o[i + 1].clone(), o[i].clone()
        out.append(o[None, :k])
    return out


def _token_logp(P, m, states, preds, labels, tokens):
    enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    ids = torch.tensor([[care.BOS] + tokens[:-1]], device=enc.device)
    return care.log_probs(P, care.decode(P, m, ids, enc, gsg))[0]


def _score(logp, tokens, alpha):
    idx = torch.arange(len(tokens), device=logp.device)
    tok = torch.tensor(tokens, device=logp.device)
    return float(logp[idx, tok].sum()) / len(tokens) ** alpha


def _rank_gap(logp, tokens, beam):
    idx = torch.arange(len(tokens), device=logp.device)
    tok = torch.tensor(tokens, device=logp.device)
    kth = torch.topk(logp, beam, dim=-1).values[:, -1]
    return float(torch.clamp_min(kth - logp[idx, tok], 0).max())


def _encode(P, m, feats_batch, device):
    feats = {c: torch.as_tensor(x, device=device)
             for c, x in zip(m["modality"], feats_batch)}
    return care.concept_scores(P, m, feats)


@torch.no_grad()
def serve_readings(P, m, batches, requests, device, control=None) -> dict:
    """``batches``: pool index -> the batch's host streams; ``requests``:
    (pool index, row, served tokens, served score). Returns the widest
    ``score_gap`` and ``rank_gap`` over the requests; with ``control``
    (a precision name) also those of the reference in that precision in
    the program's place, on the same tokens."""
    beam, alpha, k = m["beam_size"], m["beam_alpha"], m["use_attr_topk"]
    out = {"score_gap": 0.0, "rank_gap": 0.0}
    if control:
        out.update(control_score_gap=0.0, control_rank_gap=0.0)
    by_batch = {}
    for r in requests:
        by_batch.setdefault(r[0], []).append(r)
    for b, reqs in by_batch.items():
        states, preds = _encode(P, m, batches[b], device)
        if control:
            with care.precision(control):
                c_states, c_preds = _encode(P, m, batches[b], device)
        for _, row, tokens, score in reqs:
            st = {c: s[row:row + 1] for c, s in states.items()}
            pr = preds[row:row + 1]
            best = None
            for labels in concept_variants(pr, k):
                logp = _token_logp(P, m, st, pr, labels, tokens)
                gap = abs(score - _score(logp, tokens, alpha))
                if best is None or gap < best[0]:
                    best = (gap, logp)
            gap, logp = best
            out["score_gap"] = max(out["score_gap"], gap)
            out["rank_gap"] = max(out["rank_gap"],
                                  _rank_gap(logp, tokens, beam))
            if control:
                cst = {c: s[row:row + 1] for c, s in c_states.items()}
                cpr = c_preds[row:row + 1]
                with care.precision(control):
                    clogp = _token_logp(P, m, cst, cpr, care.concept_order(
                        cpr, k), tokens)
                out["control_score_gap"] = max(
                    out["control_score_gap"],
                    abs(_score(clogp, tokens, alpha) - _score(logp, tokens,
                                                              alpha)))
                out["control_rank_gap"] = max(
                    out["control_rank_gap"], _kth_gap(logp, clogp, beam))
    return out


def _kth_gap(logp, clogp, beam):
    """The control's rank gap: at each position the token that the lower
    precision ranks ``beam``-th, which its beam would keep, and how far its
    reference log-probability lies below the reference's ``beam``-th
    best."""
    kth = torch.topk(logp, beam, dim=-1).values[:, -1]
    alt = torch.topk(clogp, beam, dim=-1).indices[:, -1]
    got = logp.gather(1, alt[:, None])[:, 0]
    return float(torch.clamp_min(kth - got, 0).max())
