"""Fixed-shape batched beam search.

Port of ``care_tpu/decoding/beam_search.py``, with a Python loop where the
JAX package has ``lax.while_loop``:

* all ``batch x beam`` rows live in one ``[N*K, ...]`` tensor; finished
  instances are masked, never compacted;
* the model is driven through a ``step_fn`` that consumes one token per row
  and a carry (the KV cache), so each step attends over the cache instead of
  recomputing the prefix;
* the finished-hypothesis bookkeeping follows the reference ``Beam``: rows
  whose last token is EOS are killed with ``DEAD`` before expansion, each
  newly EOS'd row enters a finished buffer of capacity ``max(beam, topk)``
  in beam order, an instance that never finished is force-finished with all
  its rows at ``max_len``, and hypotheses rank by ``score / length**alpha``;
* ``prev_k = flat_id // vocab``.

The loop stops as soon as every instance has filled its finished buffer
(one host sync per step reads that condition, as the number of instances
still live, which ``count_live`` receives). On a mesh's model axis the
processes of a model group decode the same rows in lockstep, so that
count is all-reduced over the group and every one of them leaves at the
same step.

Spans (``utils/profiling.trace_annotation``, recorded only while a
profiler runs): ``care.beam.init`` (the initial tensors), ``care.beam.live``
(each read of the loop condition), ``care.beam.step`` (one step) over
``care.decoder.step``, ``care.head.topk``, ``care.beam.reorder`` and
``care.beam.finish``, and ``care.beam.final`` (forced finish and ranking).
"""

from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from care_tpu_torch import constants
from care_tpu_torch.ops.fused_head_topk import fused_head_beam_topk
from care_tpu_torch.ops.topk import top_k
from care_tpu_torch.utils.profiling import trace_annotation

DEAD = -1e20


def beam_search(
    step_fn: Callable[[torch.Tensor, int, Any], Tuple[torch.Tensor, Any]],
    init_carry: Any,
    batch_size: int,
    vocab_size: int,
    gather_carry: Callable[[Any, torch.Tensor], Any],
    device,
    beam_size: int = 5,
    max_len: int = 30,
    beam_alpha: float = 1.0,
    topk: int = 1,
    bos_id: int = constants.BOS,
    eos_id: int = constants.EOS,
    fused_head: Optional[Tuple[torch.Tensor, Optional[torch.Tensor]]] = None,
    model_axis=None,
    count_live: Optional[Callable[[int, int], None]] = None,
):
    """Run beam search; returns (hyp_tokens [N, topk, max_len],
    hyp_scores [N, topk], hyp_lengths [N, topk], hyp_valid [N, topk]).

    ``step_fn(last_tokens [N*K], position, carry)`` returns
    ``(log_probs [N*K, V] f32, new_carry)``; ``position`` is the 0-based
    index of ``last_tokens`` in the generated sequence (BOS is position 0).
    ``gather_carry(carry, row_idx [N*K])`` reorders the carry after the
    beams are reshuffled.

    ``fused_head=(W [V, H], b [V] or None)`` switches the expansion to
    ``fused_head_beam_topk``: ``step_fn`` then returns the decoder hidden
    states ``[N*K, H]`` and the ``[N*K, V]`` logits are never formed.
    ``model_axis`` (a mesh ``Axis``): the decode runs on every process of
    that model group, in lockstep; a ``W`` of ``V / size`` rows is this
    process's block of the vocabulary, merged over the group.
    ``count_live(N, live)`` is called before each step that runs, with the
    number of instances whose finished buffer is not yet full.
    """
    sync = model_axis is not None and model_axis.size > 1
    N, K, V = batch_size, beam_size, vocab_size
    vocab_axis = None
    if fused_head is not None and fused_head[0].shape[0] != V:
        if not sync or fused_head[0].shape[0] * model_axis.size != V:
            raise ValueError(f"head of {fused_head[0].shape[0]} rows for a "
                             f"vocabulary of {V}")
        vocab_axis = model_axis
    Fb = max(K, topk)
    long = dict(dtype=torch.long, device=device)

    with trace_annotation("care.beam.init"):
        tokens = torch.zeros((N, K, max_len), **long)
        tokens[:, :, 0] = bos_id
        # only beam row 0 is live at the first expansion (reference
        # Beam.advance uses word_prob[0] when prev_ks is empty)
        scores = torch.full((N, K), DEAD, device=device)
        scores[:, 0] = 0.0
        last_tokens = torch.full((N, K), bos_id, **long)
        fin_scores = torch.full((N, Fb), DEAD, device=device)
        fin_lengths = torch.ones((N, Fb), **long)
        fin_tokens = torch.zeros((N, Fb, max_len), **long)
        fin_count = torch.zeros((N,), **long)
        rows = torch.arange(N, device=device)
        # the live instances, counted in int64: the sum of a bool tensor
        # would first cast it, one launch more a step
        live_rows = torch.empty((N,), **long)
    carry = init_carry

    for t in range(1, max_len):
        with trace_annotation("care.beam.live"):
            live = torch.lt(fin_count, Fb, out=live_rows).sum()
            if sync:
                dist.all_reduce(live, op=dist.ReduceOp.MAX,
                                group=model_axis.group())
            live = int(live)
        if not live:
            break
        if count_live is not None:
            count_live(N, live)
        with trace_annotation("care.beam.step"):
            with trace_annotation("care.decoder.step"):
                out, carry = step_fn(last_tokens.reshape(N * K), t - 1,
                                     carry)
            with trace_annotation("care.head.topk"):
                eos_row = last_tokens == eos_id
                if fused_head is not None:
                    best_scores, best_ids = fused_head_beam_topk(
                        out, fused_head[0], fused_head[1], scores, eos_row,
                        K, vocab_axis=vocab_axis)
                else:
                    # clamp -inf masks to the finite DEAD score
                    logp = torch.clamp_min(out.reshape(N, K, V), DEAD)
                    beam_lk = scores[:, :, None] + logp
                    beam_lk = beam_lk.masked_fill(eos_row[:, :, None], DEAD)
                    best_scores, best_ids = top_k(beam_lk.reshape(N, K * V),
                                                  K)
            with trace_annotation("care.beam.reorder"):
                prev_k = torch.div(best_ids, V, rounding_mode="floor")
                new_tok = best_ids - prev_k * V
                # reorder the token history and append the new token at
                # position t
                tokens = torch.gather(
                    tokens, 1, prev_k[:, :, None].expand(N, K, max_len))
                tokens[:, :, t] = new_tok
                carry = gather_carry(carry,
                                     (rows[:, None] * K + prev_k).reshape(-1))

            with trace_annotation("care.beam.finish"):
                is_eos = new_tok == eos_id
                offs = torch.cumsum(is_eos, dim=1) - is_eos.long()
                slot = fin_count[:, None] + offs
                admit = is_eos & (slot < Fb)
                slot_c = slot.clamp(0, Fb - 1)
                zero_col = torch.zeros((N, 1), **long)
                for k in range(K):
                    a, s = admit[:, k], slot_c[:, k]
                    fin_scores[rows, s] = torch.where(a, best_scores[:, k],
                                                      fin_scores[rows, s])
                    fin_lengths[rows, s] = torch.where(a, t,
                                                       fin_lengths[rows, s])
                    # generated tokens: positions 1..t of the history (BOS
                    # excluded)
                    gen = torch.cat([tokens[:, k, 1:], zero_col], dim=1)
                    fin_tokens[rows, s] = torch.where(a[:, None], gen,
                                                      fin_tokens[rows, s])
                fin_count = torch.clamp_max(fin_count + admit.sum(dim=1), Fb)
            scores, last_tokens = best_scores, new_tok

    with trace_annotation("care.beam.final"):
        # forced finish for instances that never emitted EOS (reference
        # Beam.advance, the `len(next_ys) == max_len` branch): all rows enter
        never = fin_count == 0
        gen_all = torch.cat([tokens[:, :, 1:], torch.zeros((N, K, 1), **long)],
                            dim=2)
        forced_len = torch.full((N, K), max_len - 1, **long)
        fin_scores = torch.where(never[:, None],
                                 F.pad(scores, (0, Fb - K), value=DEAD),
                                 fin_scores)
        fin_lengths = torch.where(never[:, None],
                                  F.pad(forced_len, (0, Fb - K), value=1),
                                  fin_lengths)
        fin_tokens = torch.where(never[:, None, None],
                                 F.pad(gen_all, (0, 0, 0, Fb - K)), fin_tokens)

        # length-normalised ranking: score / timestep**alpha
        norm = fin_scores / fin_lengths.float() ** beam_alpha
        order = torch.argsort(-norm, dim=1, stable=True)[:, :topk]
        hyp_scores = torch.gather(norm, 1, order)
        hyp_lengths = torch.gather(fin_lengths, 1, order)
        hyp_tokens = torch.gather(fin_tokens, 1,
                                  order[:, :, None].expand(N, topk, max_len))
        # unfilled finished slots are not hypotheses (the reference returns
        # min(topk, n_finished))
        hyp_valid = torch.gather(fin_scores, 1, order) > DEAD / 2
        pos = torch.arange(max_len, device=device)[None, None, :]
        hyp_tokens = torch.where(pos < hyp_lengths[:, :, None], hyp_tokens, 0)
    return hyp_tokens, hyp_scores, hyp_lengths, hyp_valid
