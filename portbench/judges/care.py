"""The judge of the CARE configurations (``"judge": "care"``): the
comparisons that decide ``correct``, what the timed path produced held
against the plain reference (``reference/care.py``), and the same numbers
for the control (the reference in a lower precision put in the program's
place). A driver takes from its judge the reference's parameter shapes
(``param_shapes``), its precisions (``precision``) and the comparisons of
its kind (``serve_readings``); the harness's tests take from it the
reference's forward check against the program at test size
(``check_forward``) and the faults its comparisons must catch
(``FAULTS``).

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

from portbench import lookup, program
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


def _feats(m, B, seed=4):
    g = torch.Generator().manual_seed(seed)
    return {c: torch.randn(B, m["rows"][c], m["dims"][c], generator=g)
            for c in m["modality"]}


@torch.no_grad()
def check_forward(cfg: dict, seed: int) -> None:
    """At test size on the CPU (``cfg`` at test widths): the program's
    concept scores, concept labels, decoder inputs and logits on the
    weights drawn from ``seed`` against the reference's; raises on a
    mismatch."""
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(
        care.param_shapes(m), seed, "cpu", m)
    model = program.build_model(program.program_opt(cfg), P, "cpu")
    feats = _feats(m, 3)
    ids = torch.randint(6, m["vocab_size"], (3, 7))
    ids[:, 0] = care.BOS
    enc = model.encoding_phase([feats[c] for c in m["modality"]])
    states, preds = care.concept_scores(P, m, feats)
    assert torch.equal(preds, enc["preds_attr"])
    labels = care.concept_order(preds, m["use_attr_topk"])
    assert torch.equal(labels, enc["semantic_labels"])
    ref_enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    inputs = model.prepare_inputs_for_decoder(enc, {})
    torch.testing.assert_close(ref_enc, inputs["encoder_hidden_states"],
                               rtol=0, atol=1e-6)
    got = model.decoding_phase(ids, inputs)["logits"]
    want = care.linear(care.decode(P, m, ids, ref_enc, gsg),
                       P["cls_head.tgt_word_prj.weight"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def _stale_cache(driver, setattr):
    """The decode step returns its KV cache unchanged."""
    from care_tpu_torch.models import decoders

    step = decoders.TransformerDecoder.decode_step

    def unchanged(self, token_ids, position, state):
        copy = {"layers": [dict(l, self_k=l["self_k"].clone(),
                                self_v=l["self_v"].clone())
                           for l in state["layers"]],
                "aux": state["aux"]}
        h, _ = step(self, token_ids, position, copy)
        return h, state
    setattr(decoders.TransformerDecoder, "decode_step", unchanged)


def _altered_token(driver, setattr):
    """A token altered where K1's beam top-k produces it."""
    import importlib
    bs = importlib.import_module("care_tpu_torch.decoding.beam_search")
    topk = bs.fused_head_beam_topk

    def altered(*args, **kwargs):
        scores, ids = topk(*args, **kwargs)
        return scores, ids + 1
    setattr(bs, "fused_head_beam_topk", altered)


# each fault a serving cell of this kind can have, planted under a run at
# test size (``setattr`` undoes itself after the test): a run on one chip
# exchanges nothing between chips, and a serving cell has no batch mean
FAULTS = {"stale_cache": _stale_cache, "altered_token": _altered_token}
