"""Non-autoregressive decoding algorithms: MaskPredict, Left2Right and
EasyFirst.

Port of ``care_tpu/decoding/nar.py`` (reference
``misc/Decoding/na_algorithms.py``). Every iteration is one full decoder
forward over the whole canvas; the per-row ``select_worst`` top-k of the
reference is a double argsort (the rank of each position) against per-row
thresholds.

Plain tensor functions of fixed shape: canvases are [N*lbs, max_len] token
ids; PAD and EOS positions carry probability 1.0, so they are never masked
again. Three details keep the port token for token with the JAX package:

* ties: every sort is stable (``jnp.argsort`` is), and ties are exact here
  (every PAD position has probability 1.0, every candidate that is not
  MASK ranks at -1.0);
* the mask counts ``int(len * ratio)`` multiply in f32, the JAX package's
  weak-typed product, not in f64;
* ``left2right`` uncovers the MASK positions of the *initial* canvas in
  order (reference ``na_algorithms.py:219-233``).

A ``forward_stats`` callable (``tokens -> (argmax ids, their
probabilities)``, the fused statistics of ``ops/fused_head_topk.py``'s
``vocab_argmax_lse``) stands in for ``forward_logits``, so that the
[N, L, V] logits never exist.

Spans (``utils/profiling.trace_annotation``): each stretch of
mask-predict's bookkeeping between two passes (a pass's PAD semantics, the
template's canvas and probabilities, the choice of the positions to mask,
the masked canvas, the merge of a pass's tokens) is a ``care.nar.select`` (a teacher pass that
``masking_decision`` runs there is its own span inside it); the
candidates' final log-probabilities are a ``care.nar.final``. The passes
are the caller's.
"""

from typing import Callable, Optional

import torch

from care_tpu_torch import constants
from care_tpu_torch.utils.profiling import trace_annotation


def generate_step_with_prob(logits, zero_ids=()):
    """argmax + its probability (reference ``na_algorithms.py:6-14``):
    (ids [N, L] int64, max probs [N, L], probs [N, L, V])."""
    probs = torch.softmax(logits, dim=-1)
    for wid in zero_ids:
        probs[..., wid] = 0.0
    max_probs, idx = probs.max(dim=-1)
    # torch.max gives the first of equal maxima, as jnp.argmax does
    return idx, max_probs, probs


def _f32_count(seq_lens, ratio: float):
    """``int(seq_lens * ratio)`` with the product in f32."""
    return (seq_lens.to(torch.float32)
            * torch.tensor(ratio, dtype=torch.float32,
                           device=seq_lens.device)).to(torch.int64)


def select_worst(token_probs, num_mask):
    """Mask the ``num_mask[i]`` least-confident positions of each row
    (vectorised reference ``na_algorithms.py:128-137``); equal
    probabilities rank by position."""
    order = torch.argsort(token_probs, dim=1, stable=True)
    rank = torch.argsort(order, dim=1, stable=True)
    return rank < torch.clamp_min(num_mask, 1)[:, None]


def _apply_pad_semantics(tgt_tokens, token_probs, pad_mask, eos_mask):
    with trace_annotation("care.nar.select"):
        tgt_tokens = torch.where(pad_mask, constants.PAD, tgt_tokens)
        token_probs = torch.where(pad_mask, 1.0, token_probs)
        token_probs = torch.where(eos_mask, 1.0, token_probs)
        tgt_tokens = torch.where(eos_mask, constants.EOS, tgt_tokens)
        return tgt_tokens, token_probs


def make_generate_fn(forward_logits: Callable, pad_mask, eos_mask):
    """Wrap a full decoder forward into the reference's
    ``generate_non_autoregressive`` semantics."""
    def generate(tgt_tokens):
        toks, probs, _ = generate_step_with_prob(forward_logits(tgt_tokens))
        return _apply_pad_semantics(toks, probs, pad_mask, eos_mask)
    return generate


def make_generate_fn_from_stats(forward_stats: Callable, pad_mask,
                                eos_mask):
    """Like :func:`make_generate_fn`, from a fused statistics forward
    ``tokens -> (argmax ids, max probs)``: the [N, L, V] logits and
    probabilities never exist."""
    def generate(tgt_tokens):
        toks, probs = forward_stats(tgt_tokens)
        return _apply_pad_semantics(toks.long(), probs, pad_mask, eos_mask)
    return generate


def _setup(tgt_tokens, forward_logits, forward_stats, teacher_score):
    with trace_annotation("care.nar.select"):
        pad_mask = tgt_tokens == constants.PAD
        eos_mask = tgt_tokens == constants.EOS
        seq_lens = tgt_tokens.shape[1] - pad_mask.sum(dim=1)
    generate = (make_generate_fn_from_stats(forward_stats, pad_mask,
                                            eos_mask)
                if forward_stats is not None
                else make_generate_fn(forward_logits, pad_mask, eos_mask))
    if teacher_score is None:
        def teacher_score(tokens, is_last):
            return torch.ones(tokens.shape, dtype=torch.float32,
                              device=tokens.device)
    return pad_mask, eos_mask, seq_lens, generate, teacher_score


def _ct_pass(tgt_tokens, generate):
    """The coarse-grained template: one pass over the canvas with every
    MASK replaced by ``<vis>``; a position still predicted MASK gets
    probability 0. Returns the tokens, their probabilities and those
    positions."""
    with trace_annotation("care.nar.select"):
        vis_canvas = torch.where(tgt_tokens == constants.MASK,
                                 constants.VIS, tgt_tokens)
    tgt_tokens, token_probs = generate(vis_canvas)
    with trace_annotation("care.nar.select"):
        still_masked = tgt_tokens == constants.MASK
        token_probs = torch.where(still_masked, 0.0, token_probs)
        return tgt_tokens, token_probs, still_masked


def _refine(tgt_tokens, token_probs, mask_ind, generate):
    with trace_annotation("care.nar.select"):
        masked = torch.where(mask_ind, constants.MASK, tgt_tokens)
    new_tokens, new_probs = generate(masked)
    with trace_annotation("care.nar.select"):
        return (torch.where(mask_ind, new_tokens, tgt_tokens),
                torch.where(mask_ind, new_probs, token_probs))


def _final(tgt_tokens, token_probs, teacher_score):
    corresponding = teacher_score(tgt_tokens, True)
    with trace_annotation("care.nar.final"):
        return tgt_tokens, torch.log(token_probs * corresponding + 1e-20)


def mask_predict(
    tgt_tokens,                    # [N, L] canvas of MASK/PAD
    forward_logits: Callable,      # tokens -> logits [N, L, V]
    iterations: int = 5,
    use_ct: bool = False,
    teacher_score: Optional[Callable] = None,  # (tokens, is_last) -> probs
    forward_stats: Optional[Callable] = None,  # tokens -> (ids, max_probs)
):
    """MaskPredict (reference ``na_algorithms.py:146-197``); ``use_ct``
    first fills the canvas from the coarse-grained template."""
    pad_mask, eos_mask, seq_lens, generate, teacher_score = _setup(
        tgt_tokens, forward_logits, forward_stats, teacher_score)
    if use_ct:
        tgt_tokens, token_probs, ct_mask = _ct_pass(tgt_tokens, generate)
    else:
        tgt_tokens, token_probs = generate(tgt_tokens)

    T = iterations + 1 if use_ct else iterations
    for counter in range(1, T):
        with trace_annotation("care.nar.select"):
            corresponding = teacher_score(tgt_tokens, False)
            if use_ct and counter == 1:
                mask_ind = ct_mask
            else:
                num_mask = _f32_count(seq_lens, 1.0 - counter / T)
                mask_ind = select_worst(token_probs * corresponding,
                                        num_mask)
                # never mask PAD / EOS again (their probability is pinned
                # to 1.0, but rows of a few tokens need the guard)
                mask_ind = mask_ind & ~pad_mask & ~eos_mask
        tgt_tokens, token_probs = _refine(tgt_tokens, token_probs, mask_ind,
                                          generate)
    return _final(tgt_tokens, token_probs, teacher_score)


def _uncovered_start(tgt_tokens, pad_mask, use_ct, generate):
    """The canvas and probabilities an uncovering algorithm starts from,
    and the positions its first refinement masks under ``use_ct``."""
    if use_ct:
        tgt_tokens, token_probs, still_masked = _ct_pass(tgt_tokens,
                                                         generate)
        visual_mask = ~still_masked & ~pad_mask
    else:
        token_probs = torch.where(pad_mask, 1.0, 0.0)
        visual_mask = None
    return tgt_tokens, token_probs, visual_mask


def _q_refinements(tgt_tokens, token_probs, q_iterations, use_ct,
                   visual_mask, seq_lens, pad_mask, generate):
    for i in range(q_iterations):
        if i == 0 and use_ct:
            mask_ind = visual_mask
        else:
            num_mask = _f32_count(seq_lens, 0.4 * (1.0 - i / q_iterations))
            mask_ind = select_worst(token_probs, num_mask) & ~pad_mask
        tgt_tokens, token_probs = _refine(tgt_tokens, token_probs, mask_ind,
                                          generate)
    return tgt_tokens, token_probs


def left2right(tgt_tokens, forward_logits, q: int = 1, q_iterations: int = 1,
               use_ct: bool = False, teacher_score=None,
               forward_stats=None):
    """Left-to-right uncovering (reference ``na_algorithms.py:200-263``)."""
    pad_mask, _, seq_lens, generate, teacher_score = _setup(
        tgt_tokens, forward_logits, forward_stats, teacher_score)
    tgt_tokens, token_probs, visual_mask = _uncovered_start(
        tgt_tokens, pad_mask, use_ct, generate)

    # the MASK positions of the initial canvas, uncovered in order in
    # chunks of q
    is_mask0 = tgt_tokens == constants.MASK
    mask_rank0 = torch.cumsum(is_mask0, dim=1) - is_mask0.long()
    for start in range(0, tgt_tokens.shape[1], q):
        sel = is_mask0 & (mask_rank0 >= start) & (mask_rank0 < start + q)
        new_tokens, new_probs = generate(tgt_tokens)
        tgt_tokens = torch.where(sel, new_tokens, tgt_tokens)
        token_probs = torch.where(sel, new_probs, token_probs)

    tgt_tokens, token_probs = _q_refinements(
        tgt_tokens, token_probs, q_iterations, use_ct, visual_mask, seq_lens,
        pad_mask, generate)
    return _final(tgt_tokens, token_probs, teacher_score)


def easy_first(tgt_tokens, forward_logits, q: int = 1, q_iterations: int = 1,
               use_ct: bool = False, teacher_score=None,
               forward_stats=None):
    """Most-confident-first uncovering (reference
    ``na_algorithms.py:266-329``). The reference loops until no MASK
    remains, at most ceil(max_len / q) rounds; this runs that many, a
    complete row passing its later rounds unchanged."""
    pad_mask, _, seq_lens, generate, teacher_score = _setup(
        tgt_tokens, forward_logits, forward_stats, teacher_score)
    tgt_tokens, token_probs, visual_mask = _uncovered_start(
        tgt_tokens, pad_mask, use_ct, generate)

    for _ in range(-(-tgt_tokens.shape[1] // q)):
        mask_ind = tgt_tokens == constants.MASK
        new_tokens, new_probs = generate(tgt_tokens)
        cand = torch.where(mask_ind, new_probs, -1.0)
        order = torch.argsort(-cand, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        take = mask_ind & (rank < q)
        tgt_tokens = torch.where(take, new_tokens, tgt_tokens)
        token_probs = torch.where(take, new_probs, token_probs)

    tgt_tokens, token_probs = _q_refinements(
        tgt_tokens, token_probs, q_iterations, use_ct, visual_mask, seq_lens,
        pad_mask, generate)
    return _final(tgt_tokens, token_probs, teacher_score)


ALGORITHMS = {"mp": mask_predict, "l2r": left2right, "ef": easy_first}
