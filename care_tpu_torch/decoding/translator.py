"""Translators: batch caption generation by AR beam search.

Port of ``care_tpu/decoding/translator.py:TranslatorARFormer`` (API parity
with the reference ``models/Translator.py``): ``get_translator(opt)``
returns an object whose ``translate_batch(model, batch)`` yields per-instance
hypothesis token lists and scores. One decode encodes the batch once, builds
the KV cache with cross-attention K/V at [B] rows and the self-attention
cache at [B*beam] rows, and runs the beam loop. With the default
``fused_head_topk`` each step's vocab expansion goes through the fused
head + top-k kernel, so the [B*beam, V] logits never exist.
"""

from collections import deque
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from care_tpu_torch.decoding.beam_search import beam_search
from care_tpu_torch.models.common import unsupported
from care_tpu_torch.models.framework import Captioner
from care_tpu_torch.utils.device import resolve_device


def get_translator(opt: dict, device=None):
    """The translator for ``opt`` on ``device`` (``None`` = the CUDA card;
    raises without one unless ``"cpu"``)."""
    if opt["decoding_type"] != "ARFormer":
        raise unsupported("decoding_type", opt["decoding_type"])
    return TranslatorARFormer(opt, device)


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
        for key in ("compute_dtype_decode", "decode_head_f32"):
            if opt.get(key):
                raise unsupported(key, opt[key])
        if opt.get("fused_head_backend", "auto") != "auto":
            raise unsupported("fused_head_backend", opt["fused_head_backend"])
        if opt.get("pointer") or opt.get("cls_head") != "NaiveHead":
            raise unsupported("a head other than the plain NaiveHead")
        self.opt = opt
        self.device = resolve_device(device)
        self.beam_size = opt.get("beam_size", 5)
        self.beam_alpha = opt.get("beam_alpha", 1.0)
        self.topk = opt.get("topk", 1)
        self.max_len = opt.get("max_len", 30)
        self.fused_head = opt.get("fused_head_topk", True)
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

    def _feats(self, batch: Dict[str, Any]) -> List[torch.Tensor]:
        return [torch.as_tensor(np.asarray(f) if not torch.is_tensor(f) else f,
                                dtype=torch.float32, device=self.device)
                for f in batch["feats"]]

    @torch.no_grad()
    def dispatch(self, models, batch: Dict[str, Any]):
        """Decode one batch on the device; returns the beam's output tensors
        on the device (pair with :meth:`collect`)."""
        model = self._model(models)
        feats = self._feats(batch)
        N = feats[0].shape[0]
        enc = model.encoding_phase(feats)
        inputs = model.prepare_inputs_for_decoder(enc, batch)
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
        hyp_tokens, hyp_scores, hyp_lengths, hyp_valid = (
            t.cpu().numpy() for t in out)
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

    def translate_batches_fused(self, *args, **kwargs):
        raise unsupported("translate_batches_fused")

    def translate_batches(self, models, batches, depth: int = 2):
        """Decode an iterable of batches, keeping up to ``depth`` decodes'
        outputs on the device before fetching them, so the host's collection
        of one batch overlaps the device's work on the next. Yields
        ``(batch, (hyps, scores))`` in input order, identical to
        :meth:`translate_batch` per batch."""
        pending = deque()
        for batch in batches:
            pending.append((batch, self.dispatch(models, batch)))
            while len(pending) > depth:
                b, out = pending.popleft()
                yield b, self.collect(out)
        while pending:
            b, out = pending.popleft()
            yield b, self.collect(out)
