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
``care.decoder.step``, ``care.head.topk``, ``care.beam.finish`` (the
history's reorder and the finished bookkeeping, ``ops/beam_bookkeeping.py``:
one kernel on CUDA) and ``care.beam.reorder`` (the carry's), and
``care.beam.final`` (forced finish and ranking).

The step is one body, run eagerly or, given a ``StepGraphs``, over static
tensors in place and on CUDA as the replay of one CUDA graph a step
position (``decoding/step_graphs.py``). A replayed step records
``care.beam.step`` alone: its inner spans are entered only when the step
runs eagerly or is captured. The ranking after the last step is a body
of the same kind (``"final"``), its outputs copied out of the static ones
once it has run; the loop's initial tensors (``initial_loop``) may come
from the caller, reset in place (``reset_loop_``) by a body of its own.
"""

import types
from typing import Any, Callable, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from care_tpu_torch import constants
from care_tpu_torch.decoding.step_graphs import StepGraphs, copy_tree_
from care_tpu_torch.ops.beam_bookkeeping import beam_bookkeeping
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
    graphs: Optional[StepGraphs] = None,
    loop: Optional[dict] = None,
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
    The ranking runs as the body ``"final"``, and the outputs are copies of
    its static ones, which the next batch's ranking overwrites.
    ``loop``: the loop's tensors as ``initial_loop`` makes them, at their
    initial values (with ``graphs``, static ones); else they are made here.
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
        if loop is None:
            loop = initial_loop(N, K, max_len, topk, bos_id, device)
            if graphs is not None:
                loop = graphs.static("loop", loop)
        # each step updates the loop's tensors in place and lands its
        # carry: rebound, or with ``graphs`` copied into the static one
        s = types.SimpleNamespace(carry=init_carry, **loop)
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
        with trace_annotation("care.beam.finish"):
            row_idx = beam_bookkeeping(
                best_scores, best_ids, V, t, eos_id, s.tokens, s.scores,
                s.last_tokens, s.fin_scores, s.fin_lengths, s.fin_tokens,
                s.fin_count)
        with trace_annotation("care.beam.reorder"):
            carry = gather_carry(carry, row_idx)
        if graphs is None:
            s.carry = carry
        else:
            copy_tree_(s.carry, carry)

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
        if graphs is None:
            return _rank(s, beam_alpha, topk)
        graphs.run("final", lambda: graphs.static(
            "final", _rank(s, beam_alpha, topk)))
        # the next batch's ranking overwrites the static outputs
        return tuple(t.clone() for t in graphs.held("final"))


def initial_loop(N: int, K: int, max_len: int, topk: int = 1,
                 bos_id: int = constants.BOS, device=None) -> dict:
    """The beam loop's tensors for ``N`` instances of ``K`` beams, at
    their values before the first step: the generated tokens, the beams'
    scores and last tokens, and the finished buffer of ``max(K, topk)``
    hypotheses an instance with its count."""
    Fb = max(K, topk)
    long = dict(dtype=torch.long, device=device)
    return reset_loop_(dict(
        tokens=torch.empty((N, K, max_len), **long),
        scores=torch.empty((N, K), device=device),
        last_tokens=torch.empty((N, K), **long),
        fin_scores=torch.empty((N, Fb), device=device),
        fin_lengths=torch.empty((N, Fb), **long),
        fin_tokens=torch.empty((N, Fb, max_len), **long),
        fin_count=torch.empty((N,), **long)), bos_id)


def reset_loop_(loop: dict, bos_id: int = constants.BOS) -> dict:
    """``initial_loop``'s values written into ``loop``'s tensors."""
    loop["tokens"].zero_()
    loop["tokens"][:, :, 0] = bos_id
    # only beam row 0 is live at the first expansion (reference
    # Beam.advance uses word_prob[0] when prev_ks is empty)
    loop["scores"].fill_(DEAD)
    loop["scores"][:, 0] = 0.0
    loop["last_tokens"].fill_(bos_id)
    loop["fin_scores"].fill_(DEAD)
    loop["fin_lengths"].fill_(1)
    loop["fin_tokens"].zero_()
    loop["fin_count"].zero_()
    return loop


def _rank(s, beam_alpha: float, topk: int):
    """The loop's outcome ranked (``s``: the loop's tensors after its last
    step): (hyp_tokens, hyp_scores, hyp_lengths, hyp_valid), new tensors."""
    N, K, max_len = s.tokens.shape
    Fb = s.fin_scores.shape[1]
    long = dict(dtype=torch.long, device=s.tokens.device)
    # forced finish for instances that never emitted EOS (reference
    # Beam.advance, the `len(next_ys) == max_len` branch): all rows enter
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
    pos = torch.arange(max_len, device=s.tokens.device)[None, None, :]
    hyp_tokens = torch.where(pos < hyp_lengths[:, :, None], hyp_tokens, 0)
    return hyp_tokens, hyp_scores, hyp_lengths, hyp_valid
