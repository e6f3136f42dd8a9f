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

The step is one body, run eagerly or, given a ``StepGraphs``, over static
tensors in place and on CUDA as the replay of one CUDA graph a step
position (``decoding/step_graphs.py``). A replayed step records
``care.beam.step`` alone: its inner spans are entered only when the step
runs eagerly or is captured.
"""

from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from care_tpu_torch import constants
from care_tpu_torch.decoding.step_graphs import StepGraphs, copy_tree_
from care_tpu_torch.ops.fused_head_topk import fused_head_beam_topk
from care_tpu_torch.ops.topk import top_k
from care_tpu_torch.utils.profiling import trace_annotation

DEAD = -1e20


class _Loop:
    """The tensors the beam loop carries from step to step. A step's
    results ``land`` in them: rebound, or with ``static`` copied into them
    in place (a result a step already wrote there through ``out`` is left
    as it is)."""

    def __init__(self, static: bool = False, **tensors):
        self.static = static
        self.__dict__.update(tensors)

    def fields(self) -> dict:
        return {k: v for k, v in vars(self).items() if k != "static"}

    def out(self, name: str):
        """Where an op may write the result ``name``: its static tensor, or
        None (a new one)."""
        return getattr(self, name) if self.static else None

    def land(self, **results) -> None:
        for name, value in results.items():
            if self.static:
                copy_tree_(getattr(self, name), value)
            else:
                setattr(self, name, value)


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
    graphs: Optional[StepGraphs] = None,
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

    ``graphs`` (a ``StepGraphs`` of this decode's shape): the loop's
    tensors are its static ones, each step writes its results into them in
    place, and on a CUDA device each step runs as the replay of its CUDA
    graph (``decoding/step_graphs.py``). ``init_carry`` is then static too:
    ``gather_carry`` reorders it in place, or its result is copied into it.
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
        s = _Loop(
            tokens=torch.zeros((N, K, max_len), **long),
            # only beam row 0 is live at the first expansion (reference
            # Beam.advance uses word_prob[0] when prev_ks is empty)
            scores=torch.full((N, K), DEAD, device=device),
            last_tokens=torch.full((N, K), bos_id, **long),
            fin_scores=torch.full((N, Fb), DEAD, device=device),
            fin_lengths=torch.ones((N, Fb), **long),
            fin_tokens=torch.zeros((N, Fb, max_len), **long),
            fin_count=torch.zeros((N,), **long),
            rows=torch.arange(N, device=device))
        s.tokens[:, :, 0] = bos_id
        s.scores[:, 0] = 0.0
        if graphs is not None:
            s = _Loop(static=True, **graphs.static("loop", s.fields()))
        s.carry = init_carry
        # the live instances, counted in int64: the sum of a bool tensor
        # would first cast it, one launch more a step
        live_rows = torch.empty((N,), **long)

    def advance(t):
        """Beam step ``t`` over ``s``: the decoder step, the expansion,
        the reorder and the finished bookkeeping."""
        with trace_annotation("care.decoder.step"):
            out, carry = step_fn(s.last_tokens.reshape(N * K), t - 1,
                                 s.carry)
        with trace_annotation("care.head.topk"):
            eos_row = s.last_tokens == eos_id
            if fused_head is not None:
                best_scores, best_ids = fused_head_beam_topk(
                    out, fused_head[0], fused_head[1], s.scores, eos_row,
                    K, vocab_axis=vocab_axis)
            else:
                # clamp -inf masks to the finite DEAD score
                logp = torch.clamp_min(out.reshape(N, K, V), DEAD)
                beam_lk = s.scores[:, :, None] + logp
                beam_lk = beam_lk.masked_fill(eos_row[:, :, None], DEAD)
                best_scores, best_ids = top_k(beam_lk.reshape(N, K * V), K)
        with trace_annotation("care.beam.reorder"):
            prev_k = torch.div(best_ids, V, rounding_mode="floor")
            new_tok = torch.sub(best_ids, prev_k * V,
                                out=s.out("last_tokens"))
            # reorder the token history and append the new token at
            # position t
            tokens = torch.gather(
                s.tokens, 1, prev_k[:, :, None].expand(N, K, max_len))
            tokens[:, :, t] = new_tok
            carry = gather_carry(carry,
                                 (s.rows[:, None] * K + prev_k).reshape(-1))

        with trace_annotation("care.beam.finish"):
            rows, fin_count = s.rows, s.fin_count
            is_eos = new_tok == eos_id
            offs = torch.cumsum(is_eos, dim=1) - is_eos.long()
            slot = fin_count[:, None] + offs
            admit = is_eos & (slot < Fb)
            slot_c = slot.clamp(0, Fb - 1)
            zero_col = torch.zeros((N, 1), **long)
            for k in range(K):
                a, sl = admit[:, k], slot_c[:, k]
                s.fin_scores[rows, sl] = torch.where(
                    a, best_scores[:, k], s.fin_scores[rows, sl])
                s.fin_lengths[rows, sl] = torch.where(
                    a, t, s.fin_lengths[rows, sl])
                # generated tokens: positions 1..t of the history (BOS
                # excluded)
                gen = torch.cat([tokens[:, k, 1:], zero_col], dim=1)
                s.fin_tokens[rows, sl] = torch.where(
                    a[:, None], gen, s.fin_tokens[rows, sl])
            fin_count = torch.clamp_max(fin_count + admit.sum(dim=1), Fb,
                                        out=s.out("fin_count"))
        s.land(tokens=tokens, scores=best_scores, last_tokens=new_tok,
               fin_count=fin_count, carry=carry)

    for t in range(1, max_len):
        with trace_annotation("care.beam.live"):
            live = torch.lt(s.fin_count, Fb, out=live_rows).sum()
            if sync:
                dist.all_reduce(live, op=dist.ReduceOp.MAX,
                                group=model_axis.group())
            live = int(live)
        if not live:
            break
        if count_live is not None:
            count_live(N, live)
        with trace_annotation("care.beam.step"):
            if graphs is None:
                advance(t)
            else:
                graphs.run(t, lambda: advance(t))

    with trace_annotation("care.beam.final"):
        # forced finish for instances that never emitted EOS (reference
        # Beam.advance, the `len(next_ys) == max_len` branch): all rows
        # enter. Every tensor from here on is new: static ones are the
        # next batch's
        never = s.fin_count == 0
        gen_all = torch.cat([s.tokens[:, :, 1:],
                             torch.zeros((N, K, 1), **long)], dim=2)
        forced_len = torch.full((N, K), max_len - 1, **long)
        fin_scores = torch.where(never[:, None],
                                 F.pad(s.scores, (0, Fb - K), value=DEAD),
                                 s.fin_scores)
        fin_lengths = torch.where(never[:, None],
                                  F.pad(forced_len, (0, Fb - K), value=1),
                                  s.fin_lengths)
        fin_tokens = torch.where(never[:, None, None],
                                 F.pad(gen_all, (0, 0, 0, Fb - K)),
                                 s.fin_tokens)

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
