"""The judge of NACF CARE served with its ARB CARE teacher (``"judge":
"nacf"``): what the harness records of the program's decode, the
comparisons that decide ``correct`` against the plain reference
(``reference/nacf.py``), and the same numbers for the control.

A mask-predict score cannot be recomputed from the served tokens alone:
each position's probability comes from the pass that last predicted it.
So the driver replays the sampled requests' batches through the same
student, teacher and translator once the window has closed, and
``record`` keeps, for each batch, every student pass's canvas and output
(the translator's pass functions wrapped from outside) and each
refinement's mask (``decoding/nar.py:_refine`` wrapped). On those canvases
the reference computes in f32:

* ``replay_gap``: the replay against the served tokens and
  log-probabilities, bit for bit (infinite where a token differs, else
  the widest difference);
* ``rank_gap``: by how much a token the program took lies below the
  reference's best at the pass that took it (the template pass takes
  every word of a candidate, a refinement the masked ones), and by how
  much a candidate's length lies below the reference's ``length_beam``-th
  best length;
* ``mask_gap``: by how much the reference probability of a masked
  position exceeds that of a kept one, each from the pass that last
  predicted it; infinite where a canvas, a mask count or the number of
  passes is off the schedule (``int(len * (1 - k / T))``, the first
  refinement after the template masking what the template left
  ``<mask>``);
* ``score_gap``: the served score (the log-probabilities summed, over
  ``len ** beam_alpha``) against the reference's for the served
  candidate, the teacher's probabilities included, plus how far the
  served candidate's reference score lies below the reference's best of
  the candidates.

The control is the reference in a lower precision decoding each sampled
video on its own (``reference/nacf.py:mask_predict``), read by the same
numbers against the f32 reference, and decoded twice for its
``replay_gap``.

The top concepts are a discrete choice: where the reference's concept
probabilities tie within rounding, each order is tried
(``judges/care.py:concept_variants``) and the nearest counts.
"""

import contextlib
import copy
import math

import torch

from portbench import lookup, program
from portbench.judges import care as care_judge
from portbench.reference import care, nacf
from portbench.reference.nacf import MASK, PAD, VIS

INF = float("inf")
KEYS = ("replay_gap", "rank_gap", "mask_gap", "score_gap")

param_shapes = nacf.param_shapes
precision = nacf.precision


def teacher_config(cfg: dict) -> dict:
    """The teacher's configuration: the student's options under the
    teacher's overlay, held to the student's sizes less the keys that only
    the NAR decode reads."""
    t = copy.deepcopy(cfg)
    t["get_opt"].update(cfg["teacher"]["get_opt"])
    t["model"] = {k: v for k, v in cfg["model"].items()
                  if k not in cfg["nar_only"]}
    return t


def build(cfg: dict, P: dict, device) -> tuple:
    """(student options, student, teacher) of the program, filled with
    ``P``."""
    Ps, Pt = nacf.split(P)
    opt = program.program_opt(cfg)
    student = program.build_model(opt, Ps, device)
    teacher = program.build_model(program.program_opt(teacher_config(cfg)),
                                  Pt, device)
    return opt, student, teacher


@contextlib.contextmanager
def record(translator):
    """Record every decode ``translator`` runs in the block: a list, one
    entry a batch, of ``{"passes": [(canvas, ids, probs)], "masks":
    [mask]}`` for each student pass and refinement, on the device."""
    from care_tpu_torch.decoding import nar
    decodes = []
    student_fns, refine = translator._student_fns, nar._refine

    def recording_fns(model, inputs):
        forward_logits, forward_stats = student_fns(model, inputs)
        rec = {"passes": [], "masks": []}
        decodes.append(rec)

        def stats(tokens):
            ids, probs = forward_stats(tokens)
            rec["passes"].append((tokens.clone(), ids.clone(),
                                  probs.clone()))
            return ids, probs
        return forward_logits, stats

    def recording_refine(tgt_tokens, token_probs, mask_ind, generate):
        decodes[-1]["masks"].append(mask_ind.clone())
        return refine(tgt_tokens, token_probs, mask_ind, generate)

    translator._student_fns = recording_fns
    nar._refine = recording_refine
    try:
        yield decodes
    finally:
        del translator._student_fns
        nar._refine = refine


def video_record(rec: dict, row: int, lbs: int) -> dict:
    """Video ``row``'s candidates of a batch's record, on the host."""
    cut = slice(row * lbs, (row + 1) * lbs)
    return {"passes": [tuple(x[cut].cpu() for x in p)
                       for p in rec["passes"]],
            "masks": [x[cut].cpu() for x in rec["masks"]]}


def _side(P, m, feats):
    """The reference's encoding of one video: its states, concept
    probabilities and the concept orders to try."""
    states, preds = nacf.encode(P, m, feats)
    return states, preds, care_judge.concept_variants(preds,
                                                      m["use_attr_topk"])


def _gaps(Ps, Pt, m, ctx, rec, tokens, lprobs) -> dict:
    """rank, mask and score gaps of one video's decode record ``rec``
    against the reference's contexts ``ctx``."""
    (enc, gsg), (t_enc, t_gsg), length_lp = ctx
    lbs, use_ct = m["length_beam_size"], m["use_ct"]
    T = m["iterations"] + 1 if use_ct else m["iterations"]
    passes, masks = rec["passes"], rec["masks"]
    off = {"rank_gap": INF, "mask_gap": INF, "score_gap": INF}
    if len(passes) != T or len(masks) != T - 1:
        return off
    dev = enc.device
    passes = [tuple(x.to(dev) for x in p) for p in passes]
    masks = [x.to(dev) for x in masks]
    pad = passes[0][0] == PAD
    lengths = (~pad).sum(1)
    if not torch.equal(passes[0][0],
                       torch.where(pad, PAD, VIS if use_ct else MASK)):
        return off
    # the candidates' lengths against the reference's length beam
    lp = length_lp[0]
    sixth = torch.sort(lp, descending=True, stable=True)[0][lbs - 1]
    clamped = torch.clamp(torch.arange(len(lp), device=dev), 4, m["max_len"])
    rank = 0.0
    for n in lengths.tolist():
        scores = lp[clamped == n]
        rank = max(rank, INF if not len(scores)
                   else float(sixth - scores.max()))
    enc, gsg = enc.expand(lbs, -1, -1), gsg.expand(lbs, -1)
    mask_gap, merged, ref_p = 0.0, None, None
    for k, (canvas, ids, _) in enumerate(passes):
        ids = torch.where(pad, PAD, ids.long())
        if k == 0:
            taken = ~pad
        else:
            taken = masks[k - 1]
            if (taken & pad).any() or not torch.equal(
                    canvas, torch.where(taken, MASK, merged)):
                return dict(off, rank_gap=rank)
            if use_ct and k == 1:
                if not torch.equal(taken, (merged == MASK) & ~pad):
                    return dict(off, rank_gap=rank)
            else:
                want = [nacf.mask_count(n, k, T) for n in lengths.tolist()]
                if taken.sum(1).tolist() != want:
                    return dict(off, rank_gap=rank)
                kept = ~taken & ~pad
                hi = torch.where(taken, ref_p, -INF).max(1).values
                lo = torch.where(kept, ref_p, INF).min(1).values
                mask_gap = max(mask_gap,
                               float(torch.clamp_min(hi - lo, 0).max()))
        logp = nacf.log_probs(Ps, nacf.decode(Ps, m, canvas.long(), enc,
                                              gsg, causal=False))
        got = logp.gather(2, ids[:, :, None])[:, :, 0]
        below = logp.max(-1).values - got
        rank = max(rank, float(torch.where(taken, below, 0.0).max()))
        p = torch.where(pad, 1.0, torch.exp(got))
        if k == 0 and use_ct:
            p = torch.where(ids == MASK, 0.0, p)
        merged = ids if k == 0 else torch.where(taken, ids, merged)
        ref_p = p if k == 0 else torch.where(taken, p, ref_p)
    t = nacf.teacher_probs(Pt, m, merged, pad, t_enc.expand(lbs, -1, -1),
                           t_gsg.expand(lbs, -1))
    norm = lengths.double() ** m["beam_alpha"]
    ref_scores = (torch.log(ref_p * t + 1e-20).double().sum(1)
                  / norm).tolist()
    served = [c for c in range(lbs) if merged[c].tolist() == tokens]
    if not served:
        return {"rank_gap": rank, "mask_gap": mask_gap, "score_gap": INF}
    c = served[0]
    score = math.fsum(lprobs) / float(norm[c])
    gap = abs(score - ref_scores[c]) + max(0.0, max(ref_scores)
                                           - ref_scores[c])
    return {"rank_gap": rank, "mask_gap": mask_gap, "score_gap": gap}


def _nearest(Ps, Pt, m, feats, rec, tokens, lprobs) -> dict:
    """The gaps under the concept orders that fit best."""
    s_states, s_preds, s_orders = _side(Ps, m, feats)
    t_states, t_preds, t_orders = _side(Pt, m, feats)
    length_lp = nacf.length_log_probs(Ps, m, s_states)
    best = None
    for labels in s_orders:
        s_ctx = nacf.decoder_inputs(Ps, m, s_states, s_preds, labels)
        for t_labels in t_orders:
            t_ctx = nacf.decoder_inputs(Pt, m, t_states, t_preds, t_labels)
            g = _gaps(Ps, Pt, m, (s_ctx, t_ctx, length_lp), rec, tokens,
                      lprobs)
            if best is None or sum(g.values()) < sum(best.values()):
                best = g
    return best


def _replay_gap(served, again) -> float:
    (tokens, lprobs), (tokens2, lprobs2) = served, again
    if tokens != tokens2:
        return INF
    return max((abs(a - b) for a, b in zip(lprobs, lprobs2)), default=0.0)


@torch.no_grad()
def serve_readings(P, m, requests, device, control=None) -> dict:
    """``requests``: one dict a sampled video, with its host streams
    (``feats``: modality char -> [1, rows, dim]), its served ``tokens``
    and ``lprobs``, the replay's (``replay``) and the replay's record
    (``record``, ``video_record``'s cut). Returns the widest of each gap
    over the requests; with ``control`` (a precision name) also the
    control's, under ``control_<gap>``."""
    with nacf.precision("f32"):
        return _serve_readings(P, m, requests, device, control)


def _serve_readings(P, m, requests, device, control):
    Ps, Pt = nacf.split(P)
    out = dict.fromkeys(KEYS, 0.0)
    if control:
        out.update({"control_" + k: 0.0 for k in KEYS})
    for r in requests:
        feats = {c: torch.as_tensor(x, device=device)
                 for c, x in r["feats"].items()}
        g = _nearest(Ps, Pt, m, feats, r["record"], r["tokens"],
                     r["lprobs"])
        g["replay_gap"] = _replay_gap((r["tokens"], r["lprobs"]),
                                      r["replay"])
        for k in KEYS:
            out[k] = max(out[k], g[k])
        if control:
            with nacf.precision(control):
                own = nacf.mask_predict(Ps, Pt, m, feats)
                again = nacf.mask_predict(Ps, Pt, m, feats)
            g = _nearest(Ps, Pt, m, feats, own, own["tokens"],
                         own["lprobs"])
            g["replay_gap"] = _replay_gap(
                (own["tokens"], own["lprobs"]),
                (again["tokens"], again["lprobs"]))
            for k in KEYS:
                out["control_" + k] = max(out["control_" + k], g[k])
    return out


@torch.no_grad()
def check_forward(cfg: dict, seed: int) -> None:
    """At test size on the CPU (``cfg`` at test widths): the program's
    length scores, every pass's argmax and probabilities and the
    teacher's probabilities against the reference's on the same canvases,
    and the program's decode against the reference's own; raises on a
    mismatch."""
    from care_tpu_torch.decoding import get_translator
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(param_shapes(m), seed,
                                                      "cpu", m)
    Ps, Pt = nacf.split(P)
    opt, student, teacher = build(cfg, P, "cpu")
    feats = care_judge._feats(m, 3)
    batch = {"feats": [feats[c] for c in m["modality"]]}
    tr = get_translator(opt, device="cpu")
    with record(tr) as decodes:
        hyps, lps = tr.translate_batch(student, batch, teacher=teacher)
    teacher_p = []
    tr._teacher_fn = _recording_teacher(tr._teacher_fn, teacher_p)
    tr.translate_batch(student, batch, teacher=teacher)
    del tr._teacher_fn

    states, preds = nacf.encode(Ps, m, feats)
    got = student.encoding_phase(batch["feats"])
    torch.testing.assert_close(nacf.length_log_probs(Ps, m, states),
                               got["preds_length"], rtol=0, atol=1e-5)
    assert torch.equal(preds, got["preds_attr"])
    t_states, t_preds = nacf.encode(Pt, m, feats)
    lbs = m["length_beam_size"]
    k = m["use_attr_topk"]
    enc, gsg = nacf.decoder_inputs(Ps, m, states, preds,
                                   care.concept_order(preds, k))
    t_enc, t_gsg = nacf.decoder_inputs(Pt, m, t_states, t_preds,
                                       care.concept_order(t_preds, k))
    rep = lambda x: x.repeat_interleave(lbs, dim=0)  # noqa: E731
    pad = decodes[0]["passes"][0][0] == PAD
    for canvas, ids, probs in decodes[0]["passes"]:
        logp = nacf.log_probs(Ps, nacf.decode(Ps, m, canvas, rep(enc),
                                              rep(gsg), causal=False))
        best, want = logp.max(-1)
        assert torch.equal(torch.where(pad, PAD, want),
                           torch.where(pad, PAD, ids.long()))
        torch.testing.assert_close(torch.where(pad, 1.0, probs),
                                   torch.where(pad, 1.0, torch.exp(best)),
                                   rtol=0, atol=1e-5)
    (final, p), = teacher_p
    torch.testing.assert_close(p, nacf.teacher_probs(
        Pt, m, final, pad, rep(t_enc), rep(t_gsg)), rtol=0, atol=1e-5)
    for row in range(3):
        one = {c: feats[c][row:row + 1] for c in m["modality"]}
        own = nacf.mask_predict(Ps, Pt, m, one)
        assert own["tokens"] == hyps[row][0], (row, own["tokens"],
                                               hyps[row][0])
        torch.testing.assert_close(torch.tensor(own["lprobs"]),
                                   torch.tensor(lps[row][0]), rtol=0,
                                   atol=1e-5)


def _recording_teacher(teacher_fn, out):
    """``teacher_fn`` (a translator's ``_teacher_fn``), its last
    rescoring's tokens and probabilities kept in ``out``."""
    def fn(*args, **kwargs):
        score = teacher_fn(*args, **kwargs)

        def recording(tokens, is_last):
            p = score(tokens, is_last)
            if is_last:
                out.append((tokens.clone(), p.clone()))
            return p
        return recording
    return fn


def _dropped_pass(driver, setattr):
    """The third refinement of every decode skipped: its canvas neither
    decoded nor merged."""
    from care_tpu_torch.decoding import nar
    refine, calls = nar._refine, [0]

    def skipping(tgt_tokens, token_probs, mask_ind, generate):
        calls[0] += 1
        if calls[0] % driver.m["iterations"] == 3:
            return tgt_tokens, token_probs
        return refine(tgt_tokens, token_probs, mask_ind, generate)
    setattr(nar, "_refine", skipping)


def _no_teacher(driver, setattr):
    """The teacher's rescoring factor left at 1."""
    from care_tpu_torch.decoding.translator import TranslatorNARFormer

    def ones(self, *args, **kwargs):
        return lambda tokens, is_last: torch.ones(
            tokens.shape, dtype=torch.float32, device=tokens.device)
    setattr(TranslatorNARFormer, "_teacher_fn", ones)


def _altered_argmax(driver, setattr):
    """One argmax id of K2 altered in each candidate: its first
    position's, moved to the next word."""
    from care_tpu_torch.decoding import translator
    stats = translator.vocab_argmax_lse

    def altered(h, W, b, token_ids=None, **kwargs):
        out = stats(h, W, b, token_ids=token_ids, **kwargs)
        if token_ids is not None:
            return out
        ids = out[0].clone()
        ids[:, 0] = (ids[:, 0] + 1) % W.shape[0]
        return (ids,) + tuple(out[1:])
    setattr(translator, "vocab_argmax_lse", altered)


def _shifted_length(driver, setattr):
    """The length beam one word longer than the predictor's."""
    from care_tpu_torch.decoding.translator import TranslatorNARFormer
    length_beam = TranslatorNARFormer._length_beam

    def shifted(self, enc, N):
        lbs, beam = length_beam(self, enc, N)
        return lbs, torch.clamp(beam + 1, 4, self.max_len)
    setattr(TranslatorNARFormer, "_length_beam", shifted)


# each fault a serving cell of this kind can have, planted under a run at
# test size (``setattr`` undoes itself after the test)
FAULTS = {"dropped_pass": _dropped_pass, "no_teacher": _no_teacher,
          "altered_argmax": _altered_argmax,
          "shifted_length": _shifted_length}
