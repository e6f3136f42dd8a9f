"""Translators: batch caption generation by AR beam search.

Port of ``care_tpu/decoding/translator.py:TranslatorARFormer`` (API parity
with the reference ``models/Translator.py``): ``get_translator(opt)``
returns an object whose ``translate_batch(model, batch)`` yields per-instance
hypothesis token lists and scores. One decode encodes the batch once, builds
the KV cache with cross-attention K/V at [B] rows and the self-attention
cache at [B*beam] rows, and runs the beam loop. With the default
``fused_head_topk`` each step's vocab expansion goes through the fused
head + top-k kernel, so the [B*beam, V] logits never exist.

Three ways through a stream of batches, all giving what
:meth:`translate_batch` gives batch by batch: ``translate_batches`` keeps a
few decodes' outputs on the device before fetching them;
``translate_batches_fused`` decodes K batches back to back on the card's
stream before it fetches their outputs; and ``translate_batches_grouped``,
the ``--fused_k`` / ``eval_fused_k`` path of serving and validation, keeps
up to K decodes in flight over a stream.

Half-precision serving (``compute_dtype_decode: bfloat16``) decodes with a
bf16 copy of the model's parameters (``decode_head_f32`` keeps the vocab
head in f32) and bf16 feature streams; the caller's model is untouched.
Every module computes in the promoted dtype of its input and parameters,
as the JAX package's flax modules do, and the beam scores stay f32.
"""

import copy
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.models.common import unsupported
from care_tpu_torch.models.framework import Captioner
from care_tpu_torch.utils.device import resolve_device

# what ``compute_dtype_decode`` may say: argparse delivers the string
_DECODE_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                  torch.bfloat16: torch.bfloat16}


def get_translator(opt: dict, device=None):
    """The translator for ``opt`` on ``device`` (``None`` = the CUDA card;
    raises without one unless ``"cpu"``)."""
    if opt["decoding_type"] != "ARFormer":
        raise unsupported("decoding_type", opt["decoding_type"])
    return TranslatorARFormer(opt, device)


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
        for module in served.modules():
            if isinstance(module, torch.nn.BatchNorm1d):
                module.running_mean.data = module.running_mean.to(
                    compute_dtype)
                module.running_var.data = module.running_var.to(compute_dtype)
    return served


def auto_enlarge(tree, beam_size: int):
    """Repeat every tensor instance-major along dim 0 (reference
    ``misc/utils.py:261-279``): row n*K+k belongs to instance n."""
    if isinstance(tree, dict):
        return {k: auto_enlarge(v, beam_size) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(auto_enlarge(v, beam_size) for v in tree)
    return None if tree is None else tree.repeat_interleave(beam_size, dim=0)


def _gather_self_kv(state, row_idx):
    """Reorder the per-row self-attention cache after a beam reshuffle.
    Cross-attention K/V sit at [B] rows, shared by an instance's beams, and
    beams never move between instances, so they stay as they are."""
    for st in state["layers"]:
        st["self_k"] = st["self_k"].index_select(0, row_idx)
        st["self_v"] = st["self_v"].index_select(0, row_idx)
    return state


class TranslatorARFormer:
    """Batched beam search over a KV cache."""

    def __init__(self, opt: dict, device=None):
        if opt.get("fused_head_backend", "auto") != "auto":
            raise unsupported("fused_head_backend", opt["fused_head_backend"])
        if opt.get("pointer"):
            raise unsupported("pointer", opt["pointer"])
        self.opt = opt
        self.device = resolve_device(device)
        self.beam_size = opt.get("beam_size", 5)
        self.beam_alpha = opt.get("beam_alpha", 1.0)
        self.topk = opt.get("topk", 1)
        self.max_len = opt.get("max_len", 30)
        # the fused head streams a bias-free projection of the decoder's
        # hidden state: the plain NaiveHead, as the JAX package rules; any
        # other head decodes through its dense logits
        self.fused_head = (opt.get("fused_head_topk", True)
                           and opt.get("cls_head") == "NaiveHead")
        self.compute_dtype = decode_dtype(opt.get("compute_dtype_decode"))
        self.keep_head_f32 = bool(opt.get("decode_head_f32", False))
        # the cast copy of the last model served in half precision, with
        # the source model and the version counters of its parameters
        self._served = None
        # beam steps run by this translator, all batches together
        self.beam_steps = 0

    def _model(self, models) -> Captioner:
        if isinstance(models, (list, tuple)):
            if len(models) != 1:
                raise unsupported("ensembles of several models")
            models = models[0]
        if not isinstance(models, Captioner):
            raise TypeError(f"expected a care_tpu_torch Captioner, got "
                            f"{type(models).__name__}")
        if models.training:
            raise ValueError("translate with the model in eval mode")
        dev = next(models.parameters()).device
        if dev.type != self.device.type:
            raise ValueError(f"the model lies on {dev}, the translator "
                             f"serves on {self.device}")
        return models

    def serving_model(self, models) -> Captioner:
        """The model a decode runs: the caller's, or in half precision its
        cast copy, made again whenever the caller's parameters changed in
        place (a train step, a checkpoint load)."""
        model = self._model(models)
        if self.compute_dtype is None:
            return model
        stamp = tuple(p._version for p in model.parameters())
        if (self._served is None or self._served[0] is not model
                or self._served[1] != stamp):
            self._served = (model, stamp, _cast_variables(
                model, self.compute_dtype, self.keep_head_f32))
        return self._served[2]

    def _feats(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        dtype = self.compute_dtype or torch.float32
        return [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f) else f,
                                dtype=torch.float32,
                                device=self.device).to(dtype)
                for f in batch["feats"]]

    def _batch_inputs(self, batch: Dict[str, Any]) -> Dict[str, Any]:
        """The decoder inputs a batch carries besides its features (the
        category ids of ``with_category``), on the device."""
        return {k: torch.as_tensor(np.asarray(batch[k]) if not
                                   torch.is_tensor(batch[k]) else batch[k],
                                   device=self.device).long()
                for k in ("category",) if k in batch}

    @torch.no_grad()
    def dispatch(self, models, batch: Dict[str, Any]):
        """Decode one batch on the device; returns the beam's output tensors
        on the device (pair with :meth:`collect`)."""
        model = self.serving_model(models)
        feats = self._feats(batch)
        N = feats[0].shape[0]
        enc = model.encoding_phase(feats)
        inputs = model.prepare_inputs_for_decoder(enc,
                                                  self._batch_inputs(batch))
        carry = model.init_decode_state(inputs, self.max_len, self.beam_size)

        def step_fn(tokens, position, state):
            self.beam_steps += 1
            if self.fused_head:
                return model.decode_step_hidden(tokens, position, state)
            logits, state = model.decode_step(tokens, position, state)
            return torch.log_softmax(logits.float(), dim=-1), state

        fused = ((model.cls_head.tgt_word_prj.weight, None) if self.fused_head
                 else None)
        return beam_search(
            step_fn, carry, batch_size=N, vocab_size=self.opt["vocab_size"],
            gather_carry=_gather_self_kv, device=self.device,
            beam_size=self.beam_size, max_len=self.max_len,
            beam_alpha=self.beam_alpha, topk=self.topk, fused_head=fused)

    def collect(self, out) -> Tuple[List[List[List[int]]], List[List[float]]]:
        """Host side of one decode: fetch the outputs and collect the
        hypotheses as the reference does."""
        return self._collect_arrays(tuple(t.cpu().numpy() for t in out))

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

    def translate_batch(self, models, batch: Dict[str, Any]):
        """models: a Captioner (or a one-element list of it); batch:
        {"feats": [per-modality [B, T, dim] arrays]}. Returns (hyps, scores)
        shaped like the reference: hyps[n] = list of topk token-id lists."""
        return self.collect(self.dispatch(models, batch))

    def translate_batches(self, models, batches, depth: int = 2):
        """Decode an iterable of batches, keeping up to ``depth`` decodes'
        outputs on the device before fetching them, so the host's collection
        of one batch overlaps the device's work on the next. Yields
        ``(batch, (hyps, scores))`` in input order, identical to
        :meth:`translate_batch` per batch."""
        yield from self._pipelined(models, ((b, b) for b in batches), depth)

    def _pipelined(self, models, tagged_batches, depth: int):
        pending = deque()
        for tag, batch in tagged_batches:
            pending.append((tag, self.dispatch(models, batch)))
            while len(pending) > depth:
                t, out = pending.popleft()
                yield t, self.collect(out)
        while pending:
            t, out = pending.popleft()
            yield t, self.collect(out)

    def translate_batches_fused(self, models, batches: List[Dict[str, Any]]):
        """Decode K batches back to back on the card's stream, then fetch
        and collect their outputs; returns a list of per-batch (hyps,
        scores), identical to per-batch :meth:`translate_batch`."""
        outs = [self.dispatch(models, b) for b in batches]
        return [self.collect(out) for out in outs]

    def translate_batches_grouped(self, models, tagged_batches,
                                  fused_k: int):
        """Decode an iterable of ``(tag, batch)`` pairs with up to
        ``fused_k`` decodes in flight on the card before their outputs are
        fetched. Yields ``(tag, (hyps, scores))`` in input order, the
        results of per-batch :meth:`translate_batch`. The JAX package pads
        short batches and partial groups to the shapes of one compiled
        ``lax.map`` program; eager decodes need no padding, so every batch
        decodes at its own rows and none is decoded twice."""
        yield from self._pipelined(models, tagged_batches, max(1, fused_k))
