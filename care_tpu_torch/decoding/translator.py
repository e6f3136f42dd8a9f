"""Translators: batch caption generation by AR beam search or by NAR
refinement.

Port of ``care_tpu/decoding/translator.py`` (API parity with the reference
``models/Translator.py``): ``get_translator(opt)`` returns an object whose
``translate_batch(model, batch)`` yields per-instance hypothesis token lists
and scores.

``TranslatorARFormer`` encodes the batch once, builds the KV cache with
cross-attention K/V at [B] rows and the self-attention cache at [B*beam]
rows, and runs the beam loop. With the default ``fused_head_topk`` each
step's vocab expansion goes through the fused head + top-k kernel, so the
[B*beam, V] logits never exist; on the card such a decode of one model
keeps its tensors at fixed addresses between batches of one shape
(``_StaticDecode``) and replays each beam step as one CUDA graph
(``decoding/step_graphs.py``). Every other decode takes the dense step,
as the JAX package rules (``care_tpu/decoding/translator.py:225-230``): an
RNN decoder steps its carry (``init_rnn_carry`` on the beam-enlarged
inputs, ``rnn_decode_step``, the nested carry reordered with the beams), a
pointer model's step returns the log of its copy-mixed probabilities (its
retrieved captions enlarged to the beam rows), and an ensemble of several
``Captioner``s (``models`` a list) keeps each member's encoding, inputs
and state and averages the members' f32 log-probabilities each step; a
heterogeneous ensemble takes one feature list per model
(``models/ensemble.py:EnsembleSpec.split_feats``).

``TranslatorNARFormer`` decodes a length beam: the ``length_beam_size``
most likely lengths of each instance (from ``preds_length``), each a canvas
of MASK tokens refined by ``decoding/nar.py``'s algorithm (``paradigm``
``mp`` / ``l2r`` / ``ef``), and keeps the candidate of best length-
normalised log-probability. Each refinement pass is a full decoder forward
whose statistics (argmax and its probability) come from the argmax/lse
kernel of ``ops/fused_head_topk.py`` on a plain ``NaiveHead``; an AR
``teacher`` rescores the candidates through the same kernel
(``exp(token logit - lse)``), its vocabulary reached through
``vocab_mapping``.

Three ways through a stream of batches, all giving what
:meth:`translate_batch` gives batch by batch: ``translate_batches`` keeps a
few decodes' outputs on the device before fetching them;
``translate_batches_fused`` decodes K batches back to back on the card's
stream before it fetches their outputs; and ``translate_batches_grouped``,
the ``--fused_k`` / ``eval_fused_k`` path of serving and validation, keeps
up to K decodes in flight over a stream.

Spans (``utils/profiling.trace_annotation``, recorded only while a
profiler runs): every way through a batch opens ``care.dispatch`` around
its dispatch and ``care.collect`` around its collection (a dispatch and
its collection pair up in order); the AR translator adds ``care.encode``
(the encoders and the decoder's inputs), ``care.beam.init`` (the decode
state) and ``care.collect.fetch`` (the outputs' copy to the host), and
``decoding/beam_search.py`` the spans of the beam loop.

Half-precision serving (``compute_dtype_decode: bfloat16``) decodes with a
bf16 copy of the model's parameters (``decode_head_f32`` keeps the vocab
head in f32) and bf16 feature streams; the caller's model is untouched.
Every module computes in the promoted dtype of its input and parameters,
as the JAX package's flax modules do, and the beam scores stay f32.
"""

import copy
import itertools
import weakref
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.decoding import nar
from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.decoding.step_graphs import StepGraphs, kernel_counters
from care_tpu_torch.models.common import unsupported
from care_tpu_torch.models.decoders import is_rnn_decoder
from care_tpu_torch.models.framework import Captioner
from care_tpu_torch.models.heads import NaiveHead
from care_tpu_torch.models.weights import batch_stats_leaves
from care_tpu_torch.ops.fused_head_topk import vocab_argmax_lse
from care_tpu_torch.parallel.mesh import gather_full, is_split, model_axis
from care_tpu_torch.utils.device import resolve_device
from care_tpu_torch.utils.profiling import trace_annotation

# what ``compute_dtype_decode`` may say: argparse delivers the string
_DECODE_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  torch.bfloat16: torch.bfloat16}

# the fused decode shapes whose static state and step graphs a translator
# keeps: a test set's batches and its last, shorter one, and the models
# they decode with
_GRAPH_SHAPES = 4


def get_translator(opt: dict, device=None):
    """The translator for ``opt`` on ``device`` (``None`` = the CUDA card;
    raises without one unless ``"cpu"``)."""
    if opt["decoding_type"] == "ARFormer":
        return TranslatorARFormer(opt, device)
    if opt["decoding_type"] == "NARFormer":
        return TranslatorNARFormer(opt, device)
    raise ValueError(opt["decoding_type"])


def decode_dtype(value) -> Optional[torch.dtype]:
    """``compute_dtype_decode`` as a torch dtype (None: decode in f32)."""
    if value is None:
        return None
    try:
        return _DECODE_DTYPES[value]
    except (KeyError, TypeError):
        raise unsupported("compute_dtype_decode", value) from None


def _cast_variables(model: Captioner, compute_dtype: torch.dtype,
                    keep_head_f32: bool) -> Captioner:
    """A copy of ``model`` for serving whose floating parameters are in
    ``compute_dtype``; with ``keep_head_f32`` the vocab projection
    (``cls_head``) keeps f32. The BatchNorm running statistics are cast
    too, as the JAX package casts its ``batch_stats`` with its other
    variables; other buffers (a fixed sinusoid table) keep their dtype."""
    served = copy.deepcopy(model)
    with torch.no_grad():
        for name, p in served.named_parameters():
            if keep_head_f32 and name.startswith("cls_head."):
                continue
            if p.is_floating_point():
                p.data = p.data.to(compute_dtype)
        for _, module, attr in batch_stats_leaves(served):
            buf = getattr(module, attr)
            buf.data = buf.to(compute_dtype)
    return served


def auto_enlarge(tree, beam_size: int):
    """Repeat every tensor instance-major along dim 0 (reference
    ``misc/utils.py:261-279``): row n*K+k belongs to instance n."""
    if isinstance(tree, dict):
        return {k: auto_enlarge(v, beam_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(auto_enlarge(v, beam_size) for v in tree)
    return None if tree is None else tree.repeat_interleave(beam_size, dim=0)


def _gather_carry(carry, row_idx):
    """Reorder every tensor of an RNN carry (an LSTM's (h, c), TopDown's
    [bottom, top]) after a beam reshuffle."""
    if isinstance(carry, (list, tuple)):
        return type(carry)(_gather_carry(c, row_idx) for c in carry)
    return carry.index_select(0, row_idx)


def _gather_self_kv(state, row_idx):
    """Reorder the per-row self-attention cache after a beam reshuffle.
    Cross-attention K/V sit at [B] rows, shared by an instance's beams, and
    beams never move between instances, so they stay as they are."""
    for st in state["layers"]:
        st["self_k"] = st["self_k"].index_select(0, row_idx)
        st["self_v"] = st["self_v"].index_select(0, row_idx)
    return state


def _shapes(tree):
    """The shapes and dtypes of a nested carry of tensors (None kept)."""
    if isinstance(tree, dict):
        return tuple((k, _shapes(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return tuple(_shapes(v) for v in tree)
    return None if tree is None else (tuple(tree.shape), tree.dtype)


def _step_ptrs(model):
    """Where the tensors a decode step reads of ``model`` sit: its
    decoder's and vocab head's parameters and buffers."""
    return tuple(t.data_ptr() for part in (model.decoder, model.cls_head)
                 for t in itertools.chain(part.parameters(), part.buffers()))


class _StaticDecode:
    """What a fused decode of one model at one shape keeps between batches
    when its steps run as CUDA graphs: the carry at fixed addresses (the
    cross and concept K/V, the decoder's per-row inputs and the
    self-attention cache), a second slot of each layer's self-attention
    cache, and the step graphs. Valid while the model lives and each tensor
    of it that a step reads sits where it sat at the first batch: the
    addresses the graphs read."""

    def __init__(self, model, carry, graphs: StepGraphs):
        self.model = weakref.ref(model)
        self.ptrs = _step_ptrs(model)
        self.graphs = graphs
        self.carry = graphs.static("carry", carry)
        # step t (position t - 1) reads and appends to slot (t - 1) % 2 of
        # each layer's self-attention cache, and its beam reorder writes
        # the other: index_select may not write its own input, and a copy
        # back would move the cache twice
        self.kv_slots = [{key: (st[key], torch.empty_like(st[key]))
                          for key in ("self_k", "self_v")}
                         for st in self.carry["layers"]]

    def valid(self, model) -> bool:
        return self.model() is model and _step_ptrs(model) == self.ptrs

    def point(self, slot: int) -> None:
        """Point the carry at each self-attention cache's ``slot``."""
        for st, slots in zip(self.carry["layers"], self.kv_slots):
            for key, pair in slots.items():
                st[key] = pair[slot]

    def load(self, carry):
        """A batch's fresh carry copied into the static one."""
        self.point(0)
        return self.graphs.static("carry", carry)

    def gather(self, state, row_idx):
        """``_gather_self_kv`` into the other slot."""
        for st, slots in zip(state["layers"], self.kv_slots):
            for key, (a, b) in slots.items():
                st[key] = torch.index_select(st[key], 0, row_idx,
                                             out=b if st[key] is a else a)
        return state


class Translator:
    """What both translators share: the model checks, the half-precision
    serving copies, the batch's tensors on the device, and the three ways
    through a stream of batches. A subclass gives ``dispatch(models,
    batch, **kwargs)`` (the decode's output tensors on the device) and
    ``collect(out)`` (the host's hypotheses and scores); the keyword
    arguments of every method (the NAR translator's ``teacher`` and
    ``vocab_mapping``) reach ``dispatch``."""

    def __init__(self, opt: dict, device=None):
        if opt.get("fused_head_backend", "auto") != "auto":
            raise unsupported("fused_head_backend", opt["fused_head_backend"])
        self.opt = opt
        self.device = resolve_device(device)
        self.max_len = opt.get("max_len", 30)
        self.beam_alpha = opt.get("beam_alpha", 1.0)
        # the fused head streams a bias-free projection of the decoder's
        # hidden state: the plain NaiveHead of a Transformer decoder with no
        # pointer, as the JAX package rules; any other head, every RNN
        # decoder, a pointer model and an ensemble decode through their
        # dense log-probabilities
        self.is_rnn = is_rnn_decoder(opt)
        self.fused_head = (opt.get("fused_head_topk", True)
                           and opt.get("cls_head") == "NaiveHead"
                           and not self.is_rnn and not opt.get("pointer"))
        self.compute_dtype = decode_dtype(opt.get("compute_dtype_decode"))
        self.keep_head_f32 = bool(opt.get("decode_head_f32", False))
        # the cast copies of the models served in half precision, by the
        # id of the source model: (source model, the version counters of
        # its parameters, cast copy)
        self._served = {}

    def _models(self, models) -> List[Captioner]:
        """``models`` (a Captioner, or a list of them: an ensemble) as a
        checked list."""
        models = (list(models) if isinstance(models, (list, tuple))
                  else [models])
        if not models:
            raise ValueError("no model to translate with")
        for model in models:
            if not isinstance(model, Captioner):
                raise TypeError(f"expected a care_tpu_torch Captioner, got "
                                f"{type(model).__name__}")
            if model.training:
                raise ValueError("translate with the model in eval mode")
            dev = next(model.parameters()).device
            if dev.type != self.device.type:
                raise ValueError(f"the model lies on {dev}, the translator "
                                 f"serves on {self.device}")
        return models

    def serving_model(self, model) -> Captioner:
        """The model a decode runs (a Captioner or a one-element list): the
        caller's, or in half precision its cast copy, made again whenever
        the caller's parameters changed in place (a train step, a
        checkpoint load)."""
        models = self._models(model)
        if len(models) != 1:
            raise ValueError(f"one model expected, got {len(models)}")
        model = models[0]
        if self.compute_dtype is None:
            return model
        stamp = tuple(p._version for p in model.parameters())
        served = self._served.get(id(model))
        if served is None or served[0] is not model or served[1] != stamp:
            served = (model, stamp, _cast_variables(
                model, self.compute_dtype, self.keep_head_f32))
            self._served[id(model)] = served
        return served[2]

    def _tensor(self, x) -> torch.Tensor:
        """A feature stream ``x`` on the device: floating streams in the
        serving dtype (by way of f32), integer ones (the ``t`` stream's
        token ids) as int64, never through a float."""
        t = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))
        if not t.is_floating_point():
            return t.to(self.device).long()
        return torch.as_tensor(t, dtype=torch.float32,
                               device=self.device).to(
                                   self.compute_dtype or torch.float32)

    def _feats(self, batch: Dict[str, Any]):
        """The batch's feature streams on the device; a heterogeneous
        ensemble's batch holds one list of streams per model."""
        return [[self._tensor(x) for x in f]
                if isinstance(f, (list, tuple)) else self._tensor(f)
                for f in batch["feats"]]

    def _batch_inputs(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The decoder inputs a batch carries besides its features (the
        category of ``with_category``, the category vectors of
        ``use_category_embs``), on the device: the Transformer's category
        ids as int64, the RNN decoders' one-hot rows and the category
        vectors as given."""
        out = {}
        for k in ("category", "category_embs"):
            if k in batch:
                t = torch.as_tensor(np.asarray(batch[k]) if not
                                    torch.is_tensor(batch[k]) else batch[k],
                                    device=self.device)
                out[k] = t if t.is_floating_point() else t.long()
        return out

    def _dispatch(self, models, batch, kwargs):
        with trace_annotation("care.dispatch"):
            return self.dispatch(models, batch, **kwargs)

    def _collect(self, out):
        with trace_annotation("care.collect"):
            return self.collect(out)

    def translate_batch(self, models, batch: Dict[str, Any], **kwargs):
        """models: a Captioner (or a one-element list of it); batch:
        {"feats": [per-modality [B, T, dim] arrays]}. Returns (hyps, scores)
        shaped like the reference: hyps[n] = list of topk token-id lists."""
        return self._collect(self._dispatch(models, batch, kwargs))

    def translate_batches(self, models, batches, depth: int = 2, **kwargs):
        """Decode an iterable of batches, keeping up to ``depth`` decodes'
        outputs on the device before fetching them, so the host's collection
        of one batch overlaps the device's work on the next. Yields
        ``(batch, (hyps, scores))`` in input order, identical to
        :meth:`translate_batch` per batch."""
        yield from self._pipelined(models, ((b, b) for b in batches), depth,
                                   kwargs)

    def _pipelined(self, models, tagged_batches, depth: int, kwargs):
        pending = deque()
        for tag, batch in tagged_batches:
            pending.append((tag, self._dispatch(models, batch, kwargs)))
            while len(pending) > depth:
                t, out = pending.popleft()
                yield t, self._collect(out)
        while pending:
            t, out = pending.popleft()
            yield t, self._collect(out)

    def translate_batches_fused(self, models, batches: List[Dict[str, Any]],
                                **kwargs):
        """Decode K batches back to back on the card's stream, then fetch
        and collect their outputs; returns a list of per-batch (hyps,
        scores), identical to per-batch :meth:`translate_batch`."""
        outs = [self._dispatch(models, b, kwargs) for b in batches]
        return [self._collect(out) for out in outs]

    def translate_batches_grouped(self, models, tagged_batches,
                                  fused_k: int, **kwargs):
        """Decode an iterable of ``(tag, batch)`` pairs with up to
        ``fused_k`` decodes in flight on the card before their outputs are
        fetched. Yields ``(tag, (hyps, scores))`` in input order, the
        results of per-batch :meth:`translate_batch`. The JAX package pads
        short batches and partial groups to the shapes of one compiled
        ``lax.map`` program; eager decodes need no padding, so every batch
        decodes at its own rows and none is decoded twice."""
        yield from self._pipelined(models, tagged_batches, max(1, fused_k),
                                   kwargs)


class TranslatorARFormer(Translator):
    """Batched beam search over a KV cache."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device)
        self.beam_size = opt.get("beam_size", 5)
        self.topk = opt.get("topk", 1)
        # beam steps run by this translator, all batches together; an
        # instance counts in each step it takes part in, and is live there
        # while its finished buffer is not yet full (instances that have
        # finished stay in the beam's rows, masked)
        self.beam_steps = 0
        self.instance_steps = 0
        self.live_instance_steps = 0
        # beam steps run by a replay of their CUDA graph
        self.graph_steps = 0
        # _StaticDecode by (model, carry shapes), the latest used last
        self._static = OrderedDict()

    def _count_live(self, instances: int, live: int) -> None:
        self.instance_steps += instances
        self.live_instance_steps += live

    @torch.no_grad()
    def dispatch(self, models, batch: Dict[str, Any], **unused):
        """Decode one batch on the device with one model or an ensemble (a
        list); returns the beam's output tensors on the device (pair with
        :meth:`collect`). A teacher given with the batch is not used, as in
        the JAX package."""
        models = [self.serving_model(m) for m in self._models(models)]
        feats = self._feats(batch)
        per_model = isinstance(feats[0], list)
        if per_model and len(feats) != len(models):
            raise ValueError(f"{len(feats)} feature lists for "
                             f"{len(models)} models")
        aux = self._batch_inputs(batch)
        N = (feats[0][0] if per_model else feats[0]).shape[0]
        members = []
        with trace_annotation("care.encode"):
            for i, model in enumerate(models):
                enc = model.encoding_phase(feats[i] if per_model else feats)
                members.append((model,
                                model.prepare_inputs_for_decoder(enc, aux)))
        if self.fused_head and len(members) == 1:
            return self._dispatch_fused(*members[0], N)
        return self._dispatch_dense(members, N)

    def _graphs_engage(self, model) -> bool:
        """Whether a fused decode of ``model`` runs each beam step as the
        replay of a CUDA graph: on a CUDA device, unless a model axis of
        several processes merges the vocabulary inside the step (an
        all-reduce)."""
        ax = model_axis(model)
        return self.device.type == "cuda" and (ax is None or ax.size == 1)

    def _count_graph_step(self) -> None:
        self.graph_steps += 1

    def _static_decode(self, model, carry) -> _StaticDecode:
        """The static state and step graphs of ``model`` at this carry's
        shapes, the carry loaded into it. The first batch's carry becomes
        the static one; a model whose tensors moved (another model, a
        loaded state whose tensors were replaced) starts anew, so a graph
        never reads a stale address."""
        key = (id(model), _shapes(carry))
        entry = self._static.pop(key, None)
        if entry is not None and not entry.valid(model):
            entry = None
        if entry is None:
            # drop the static decodes of models gone and the least recently
            # used beyond the bound, once the card has run their graphs
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            for k in [k for k, e in self._static.items()
                      if e.model() is None]:
                del self._static[k]
            while len(self._static) >= _GRAPH_SHAPES:
                self._static.popitem(last=False)
            entry = _StaticDecode(model, carry, StepGraphs(
                self.device, [(self, "beam_steps")] + kernel_counters(),
                on_replay=self._count_graph_step))
        self._static[key] = entry
        entry.load(carry)
        return entry

    def _dispatch_fused(self, model, inputs, N: int):
        """One model through the fused head + top-k: the step returns the
        decoder's hidden states. Where ``_graphs_engage``, the decode runs
        over a ``_StaticDecode``'s tensors and each step replays a CUDA
        graph."""
        static = None
        with trace_annotation("care.beam.init"):
            carry = model.init_decode_state(inputs, self.max_len,
                                            self.beam_size)
            if self._graphs_engage(model):
                static = self._static_decode(model, carry)
                carry = static.carry

        def step_fn(tokens, position, state):
            self.beam_steps += 1
            if static is not None:
                static.point(position % 2)
            return model.decode_step_hidden(tokens, position, state)

        # on a model axis: this process's vocab rows (when they split),
        # merged in the head
        return beam_search(
            step_fn, carry, batch_size=N, vocab_size=self.opt["vocab_size"],
            gather_carry=_gather_self_kv if static is None else static.gather,
            device=self.device, beam_size=self.beam_size,
            max_len=self.max_len, beam_alpha=self.beam_alpha, topk=self.topk,
            fused_head=(model.cls_head.tgt_word_prj.weight, None),
            model_axis=model_axis(model), count_live=self._count_live,
            graphs=None if static is None else static.graphs)

    def _dispatch_dense(self, members, N: int):
        """The dense step of one model or an ensemble: each member's carry
        (a KV cache from the un-enlarged inputs, or an RNN carry from the
        beam-enlarged ones) and each member's f32 log-probabilities (a
        pointer model's step gives them itself), averaged over the
        members."""
        beam = self.beam_size
        carries, step_inputs = [], []
        with trace_annotation("care.beam.init"):
            for model, inputs in members:
                if model.is_rnn:
                    inputs = auto_enlarge(inputs, beam)
                    carries.append(model.init_rnn_carry(inputs))
                else:
                    carries.append(model.init_decode_state(
                        inputs, self.max_len, beam))
                    # the pointer reads the retrieved captions at every
                    # beam row, as the JAX package enlarges them
                    inputs = (auto_enlarge(
                        {k: inputs[k] for k in ("ret_text_embs",
                                                "ret_input_ids")}, beam)
                              if model.pointer is not None else None)
                step_inputs.append(inputs)

        def step_fn(tokens, position, carry):
            self.beam_steps += 1
            logps, new_carry = [], []
            for (model, _), inputs, c in zip(members, step_inputs, carry):
                if model.is_rnn:
                    out, c = model.rnn_decode_step(tokens, c, inputs)
                    is_prob = False
                else:
                    out, c, is_prob = model.decode_step(tokens, position, c,
                                                        inputs)
                out = out.float()
                logps.append(out if is_prob
                             else torch.log_softmax(out, dim=-1))
                new_carry.append(c)
            logp = (logps[0] if len(logps) == 1
                    else torch.stack(logps).mean(dim=0))
            return logp, new_carry

        def gather_carry(carry, row_idx):
            return [_gather_carry(c, row_idx) if model.is_rnn
                    else _gather_self_kv(c, row_idx)
                    for (model, _), c in zip(members, carry)]

        return beam_search(
            step_fn, carries, batch_size=N,
            vocab_size=self.opt["vocab_size"], gather_carry=gather_carry,
            device=self.device, beam_size=beam, max_len=self.max_len,
            beam_alpha=self.beam_alpha, topk=self.topk,
            model_axis=model_axis(members[0][0]), count_live=self._count_live)

    def collect(self, out) -> Tuple[List[List[List[int]]], List[List[float]]]:
        """Host side of one decode: fetch the outputs and collect the
        hypotheses as the reference does."""
        with trace_annotation("care.collect.fetch"):
            arrays = tuple(t.cpu().numpy() for t in out)
        return self._collect_arrays(arrays)

    def _collect_arrays(self, arrays):
        hyp_tokens, hyp_scores, hyp_lengths, hyp_valid = arrays
        all_hyp, all_scores = [], []
        # the reference's collect_hypothesis_and_scores reassigns
        # n_best = min(n_best, len(scores)) inside the instance loop
        # (Translator.py:211-220), so one under-filled beam caps every
        # later instance's hypothesis count; reproduced for parity
        n_best = self.topk
        for n in range(hyp_tokens.shape[0]):
            hyps, scores = [], []
            for k in range(hyp_tokens.shape[1]):
                if not hyp_valid[n, k]:
                    continue
                length = int(hyp_lengths[n, k])
                hyps.append(hyp_tokens[n, k, :length].tolist())
                scores.append(float(hyp_scores[n, k]))
            n_best = min(n_best, len(hyps))
            all_hyp.append(hyps[:n_best])
            all_scores.append(scores[:n_best])
        return all_hyp, all_scores


def _whole_head_weight(model):
    """The vocab projection [V, H]; on a mesh's model axis the blocks of
    every process gathered (the NAR passes take the argmax/lse kernel over
    the whole vocabulary)."""
    layer = model.cls_head.tgt_word_prj
    ax = model_axis(model)
    if ax is None or not is_split(layer):
        return layer.weight
    return gather_full(layer.weight, 0, ax)


def _last(x):
    """The last pass of the two-stage decoder's outputs (a list)."""
    return x[-1] if isinstance(x, list) else x


class TranslatorNARFormer(Translator):
    """Length-beam NAR refinement (replaces the reference's
    ``Translator_NARFormer``), with optional AR-teacher rescoring."""

    def __init__(self, opt: dict, device=None):
        super().__init__(opt, device)
        self.paradigm = opt.get("paradigm", "mp")
        if self.paradigm not in nar.ALGORITHMS:
            raise ValueError(f"unknown NAR paradigm `{self.paradigm}`")
        self.length_beam_size = opt["length_beam_size"]
        self.length_bias = opt.get("length_bias", 0)
        self.fused_chunk = int(opt.get("fused_head_chunk", 1024))
        # full decoder forwards run by this translator, all batches
        # together: the student's refinement passes and the teacher's
        # rescoring passes
        self.decoder_passes = 0
        self.teacher_passes = 0

    def _length_beam(self, enc, N: int):
        """(lbs, lengths [N, lbs]) of the reference's length beam
        (``Translator.py:307-318``)."""
        if "preds_length" in enc:
            lbs = self.length_beam_size
            # lax.top_k's order: descending, ties to the lowest length
            beam = torch.argsort(enc["preds_length"], dim=-1,
                                 descending=True, stable=True)[:, :lbs]
            beam = torch.clamp(beam + self.length_bias, 4, self.max_len)
            return lbs, beam
        lo, hi = self.opt.get("na_length_range", [5, 11])
        # the reference adapts the beam to the range (Translator.py:272)
        beam = torch.arange(lo, hi, device=self.device)[None, :]
        return hi - lo, beam.expand(N, hi - lo)

    def _student_fns(self, model, inputs):
        """(forward_logits, forward_stats) of the refinement passes: the
        dense logits, and with the fused head the argmax/lse kernel's
        (argmax, exp(max - lse)) from the hidden states (None without)."""
        def forward_logits(tokens):
            self.decoder_passes += 1
            out = model.decoding_phase(tokens, inputs, collect_aux=False)
            # softmax, argmax and the probabilities stay f32 under
            # half-precision decode
            return _last(out["logits"]).float()

        if not self.fused_head:
            return forward_logits, None
        W = _whole_head_weight(model)

        def forward_stats(tokens):
            self.decoder_passes += 1
            out = model.decoding_phase(tokens, inputs, collect_aux=False,
                                       compute_logits=False)
            idx, mx, lse = vocab_argmax_lse(_last(out["hidden_states"]), W,
                                            None, chunk_size=self.fused_chunk)
            return idx, torch.exp(mx - lse)

        return forward_logits, forward_stats

    def _teacher_fn(self, teacher, feats, batch_aux, lbs, canvas,
                    vocab_mapping):
        """``teacher_score(tokens, is_last)``: the AR teacher's probability
        of each token given the ones before it (BOS first), the canvas's
        PAD positions (and EOS, before the last call) at 1.0. The
        ``masking_decision`` / ``no_candidate_decision`` gates leave a call
        at all-ones."""
        opt = self.opt
        t_inputs = auto_enlarge(teacher.prepare_inputs_for_decoder(
            teacher.encoding_phase(feats), batch_aux), lbs)
        pad_mask = canvas == constants.PAD
        eos_mask = canvas == constants.EOS
        # a pointer teacher comes back with its logits, which the JAX
        # package then takes
        fused = (opt.get("fused_head_topk", True)
                 and isinstance(teacher.cls_head, NaiveHead)
                 and teacher.pointer is None)

        def teacher_score(tokens, is_last):
            if (is_last and opt.get("no_candidate_decision", False)) or (
                    not is_last and not opt.get("masking_decision", False)):
                return torch.ones(tokens.shape, dtype=torch.float32,
                                  device=tokens.device)
            self.teacher_passes += 1
            toks = tokens if vocab_mapping is None else vocab_mapping[tokens]
            bos = torch.full((toks.shape[0], 1), constants.BOS,
                             dtype=toks.dtype, device=toks.device)
            prev = torch.cat([bos, toks], dim=1)[:, :-1]
            out = teacher.decoding_phase(prev, t_inputs, collect_aux=False,
                                         compute_logits=not fused)
            if fused:
                _, _, lse, tok = vocab_argmax_lse(
                    _last(out["hidden_states"]), _whole_head_weight(teacher),
                    None,
                    token_ids=toks, chunk_size=self.fused_chunk)
                p = torch.exp(tok - lse)
            else:
                probs = torch.softmax(out["logits"].float(), dim=-1)
                p = torch.gather(probs, 2, toks[:, :, None])[:, :, 0]
            p = torch.where(pad_mask, 1.0, p)
            if not is_last:
                p = torch.where(eos_mask, 1.0, p)
            return p

        return teacher_score

    @torch.no_grad()
    def dispatch(self, models, batch: Dict[str, Any], teacher=None,
                 vocab_mapping=None):
        """Decode one batch on the device; returns (hypotheses, log-probs),
        each [N, 1, max_len] on the device (pair with :meth:`collect`).
        ``teacher``: an AR Captioner in eval mode on the same device, which
        rescores the candidates; ``vocab_mapping``: the student-id ->
        teacher-id array when their vocabularies differ."""
        # one model (serving_model refuses several), as care_tpu decodes
        model = self.serving_model(models)
        feats = self._feats(batch)
        batch_aux = self._batch_inputs(batch)
        N = feats[0].shape[0]
        enc = model.encoding_phase(feats)
        lbs, beam = self._length_beam(enc, N)
        inputs = auto_enlarge(model.prepare_inputs_for_decoder(enc,
                                                               batch_aux),
                              lbs)
        lengths = beam.reshape(N * lbs)
        pos = torch.arange(self.max_len, device=self.device)[None, :]
        canvas = torch.where(pos < lengths[:, None], constants.MASK,
                             constants.PAD)

        forward_logits, forward_stats = self._student_fns(model, inputs)
        teacher_score = None
        if teacher is not None:
            if vocab_mapping is not None:
                vocab_mapping = torch.as_tensor(
                    np.asarray(vocab_mapping), device=self.device).long()
            teacher_score = self._teacher_fn(
                self.serving_model(teacher), feats, batch_aux, lbs, canvas,
                vocab_mapping)

        opt = self.opt
        if self.paradigm == "mp":
            algo_kwargs = dict(iterations=opt.get("iterations", 5),
                               use_ct=opt.get("use_ct", False))
        else:
            algo_kwargs = dict(q=opt.get("q", 1),
                               q_iterations=opt.get("q_iterations", 1),
                               use_ct=opt.get("use_ct", False))
        hypotheses, lprobs = nar.ALGORITHMS[self.paradigm](
            canvas, forward_logits, teacher_score=teacher_score,
            forward_stats=forward_stats, **algo_kwargs)

        hypotheses = hypotheses.reshape(N, lbs, self.max_len)
        lprobs = lprobs.reshape(N, lbs, self.max_len)
        tgt_lengths = lengths.reshape(N, lbs).to(torch.float32)
        avg_log_prob = lprobs.sum(-1) / (tgt_lengths ** self.beam_alpha)
        best = avg_log_prob.argmax(dim=-1)[:, None, None]
        # [N, 1, max_len], the reference's output layout
        return (torch.gather(hypotheses, 1,
                             best.expand(N, 1, self.max_len)),
                torch.gather(lprobs, 1, best.expand(N, 1, self.max_len)))

    def collect(self, out):
        """(hypotheses, log-probs) as nested lists [N][1][max_len]."""
        hyp, lp = out
        return hyp.cpu().numpy().tolist(), lp.cpu().numpy().tolist()
