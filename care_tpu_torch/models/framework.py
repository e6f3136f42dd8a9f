"""The Captioner: (backbone ->) encoder -> concept predictor -> decoder ->
vocab head (-> pointer).

Port of ``care_tpu/models/framework.py`` (reference ``models/Framework.py``):
``encoding_phase`` runs the image backbone of ``with_backbones`` on raw
frames (``models/backbone.py``), the encoder and the predictor, and merges
the predictor's outputs (with the ``preds_length`` of NAR decoding) into the
decoder inputs (the LSG ``concat`` mode appends the concept-slot
embeddings to the encoder states); ``decoding_phase`` runs
the decoder, the head and the pointer; ``init_decode_state`` /
``decode_step`` drive the KV-cached decode. The retrieved-text stream
``t`` (token ids [B, R, L]) is embedded by ``TextEmbedder`` (its own
embeddings, or the decoder's word and position embeddings; with
``has_retrieval_rnn`` refined by a bidirectional LSTM) and reaches the
PointerGen copy head (``models/pointer.py``) as ``ret_text_embs`` /
``ret_input_ids``. Submodules are named after the JAX package's parameter
tree (``encoder.Encoder_A.linear``, ``decoder.layer_0.inter_attention``,
``pointer.Wq``, ...), which ``models/weights.py`` relies on.

With an RNN decoder (``is_rnn``) the decoding phase is the decoder's time
loop (teacher forcing, or scheduled sampling at ``schedule_sampling_prob``
in training mode), and serving steps the cell through ``init_rnn_carry`` /
``rnn_decode_step`` instead of the KV cache.
"""

from typing import Any, Dict, List

import torch
from torch import nn

from care_tpu_torch.models.backbone import get_backbone
from care_tpu_torch.models.common import Dropout, LayerNorm
from care_tpu_torch.models.decoders import (OptimizedLSTMCellTorch,
                                            get_decoder, is_rnn_decoder)
from care_tpu_torch.models.embeddings import NaiveEmbeddings
from care_tpu_torch.models.encoders import get_encoder
from care_tpu_torch.models.heads import get_cls_head
from care_tpu_torch.models.pointer import get_pointer
from care_tpu_torch.models.predictors import Predictor, has_predictor
from care_tpu_torch.utils.device import resolve_device
from care_tpu_torch.utils.profiling import trace_annotation


def input_keys_for_decoder(opt: dict) -> List[str]:
    """Which encoding-phase outputs (or batch entries) are static decoder
    inputs (reference ``Framework.py:20-40``)."""
    keys = ["encoder_hidden_states"]
    if opt.get("with_category", False):
        keys.append("category_embs" if opt.get("use_category_embs", False)
                    else "category")
    t = opt.get("use_attr_type") or ""
    if opt.get("use_attr", False) and ("prefix" in t or "att" in t.lower()):
        keys.append("semantic_embs")
    if "emb" in t:
        keys.append("semantic_hidden_states")
    if (opt.get("compositional_intra") or opt.get("compositional_inter")
            or opt.get("compositional_ffn")):
        keys.append("preds_attr")
    if opt.get("pointer"):
        keys += ["ret_text_embs", "ret_input_ids"]
    return keys


class FlaxRNN(nn.Module):
    """flax's ``nn.RNN`` over [N, L, D] with a zero initial carry: the
    ``cell`` steps along the time axis, from the end with ``reverse`` (the
    outputs kept in input order, flax's ``keep_order``). No sequence
    lengths: the cell runs over the PAD tail too, as in ``care_tpu``."""

    def __init__(self, cell: nn.Module, features: int, reverse: bool = False):
        super().__init__()
        self.cell = cell
        self.features = features
        self.reverse = reverse

    def forward(self, x):
        zeros = x.new_zeros(x.shape[0], self.features)
        carry, outs = (zeros, zeros), []
        steps = range(x.shape[1])
        for t in (reversed(steps) if self.reverse else steps):
            carry, y = self.cell(carry, x[:, t])
            outs.append(y)
        if self.reverse:
            outs.reverse()
        return torch.stack(outs, dim=1)


class TextEmbedder(nn.Module):
    """Embeds the retrieved-caption token ids of the ``t`` stream
    [B, n_retrieval, L] (reference ``models/Encoder.py:341-376``): with
    ``has_retrieval_embs`` its own ``embs``, else the decoder's word and
    position embeddings; with ``has_retrieval_rnn`` then the mean of a
    forward and a reverse LSTM (flax's ``OptimizedLSTMCell``), a LayerNorm
    and dropout 0.5."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        D = opt["dim_hidden"]
        self.embs = None
        if opt.get("has_retrieval_embs", False):
            self.embs = NaiveEmbeddings(
                n_words=opt["vocab_size"], n_positions=opt["max_len"],
                dim_hidden=D, layer_norm_eps=opt["layer_norm_eps"],
                hidden_dropout_prob=opt["hidden_dropout_prob"],
                generator=generator, zero_pad_row=True)
        self.rnn_fwd = self.rnn_bwd = None
        if opt.get("has_retrieval_rnn", False):
            self.rnn_fwd = FlaxRNN(OptimizedLSTMCellTorch(D, D, generator), D)
            self.rnn_bwd = FlaxRNN(OptimizedLSTMCellTorch(D, D, generator), D,
                                   reverse=True)
            self.LayerNorm = LayerNorm(D, eps=opt["layer_norm_eps"])
            self.rnn_dropout = Dropout(0.5)

    def forward(self, input_ids, embeddings_module=None):
        if input_ids.dim() != 3:
            raise ValueError(f"text ids {tuple(input_ids.shape)} are not "
                             f"[B, n_retrieval, L]")
        bsz, n_retrieval, max_len = input_ids.shape
        flat = input_ids.reshape(bsz * n_retrieval, max_len)
        if self.embs is not None:
            embs = self.embs(flat)
        else:
            embs = embeddings_module(flat, only_word_and_position=True)
        if self.rnn_fwd is not None:
            embs = (self.rnn_fwd(embs) + self.rnn_bwd(embs)) / 2
            embs = self.rnn_dropout(self.LayerNorm(embs))
        return embs.reshape(bsz, n_retrieval, max_len, -1)


class Captioner(nn.Module):
    """One module owning encoder / predictor / decoder / head / pointer."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        self.opt = opt
        self.backbone = get_backbone(opt, generator)
        self.encoder = get_encoder(opt, generator)
        self.predictor = (Predictor(opt, generator) if has_predictor(opt)
                          else None)
        self.decoder = get_decoder(opt, generator)
        self.cls_head = get_cls_head(opt, generator)
        self.pointer = get_pointer(opt, generator)
        self.text_embedder = (TextEmbedder(opt, generator)
                              if "t" in opt["modality"] else None)
        self.decoder_input_keys = input_keys_for_decoder(opt)
        self.is_rnn = is_rnn_decoder(opt)

    # ------------------------------------------------------------------
    def encoding_phase(self, feats: List[torch.Tensor]) -> Dict[str, Any]:
        """``feats``: one entry per modality character; an entry after
        them is the ``semantic_logits`` list when ``logits`` is set."""
        modality = self.opt["modality"]
        feats, other_feats = list(feats[:len(modality)]), feats[len(modality):]
        semantic_logits = (other_feats[0] if other_feats
                           and self.opt.get("logits") else None)
        if self.backbone is not None:
            # raw frames [B, F, H, W, 3] -> [B, F, D], at the batch's rows
            # (the translator enlarges by the beam after encoding)
            feats = self.backbone(feats)
        ret_input_ids = ret_text_embs = None
        dense_feats = []
        for char, f in zip(modality, feats):
            if char == "t":
                ret_input_ids = f
                ret_text_embs = self.text_embedder(
                    f, embeddings_module=self._decoder_embedding())
            else:
                dense_feats.append(f)
        data = self.encoder(dense_feats)
        inputs_for_predictor = data.pop("inputs_for_predictor", data)
        inputs_for_decoder = data.pop("inputs_for_decoder", data)
        if ret_input_ids is not None:
            inputs_for_decoder["ret_input_ids"] = ret_input_ids
            inputs_for_decoder["ret_text_embs"] = ret_text_embs
        if self.predictor is not None:
            inputs_for_decoder.update(self.predictor(
                inputs_for_predictor["encoder_hidden_states"],
                mean_encoder_hidden_states=inputs_for_predictor.get(
                    "mean_encoder_hidden_states"),
                semantic_logits=semantic_logits))
            if "concat" in (self.opt.get("use_attr_type") or ""):
                inputs_for_decoder["encoder_hidden_states"] = torch.cat(
                    [inputs_for_decoder["encoder_hidden_states"],
                     inputs_for_decoder["semantic_embs"]], dim=1)
        return inputs_for_decoder

    def _decoder_embedding(self):
        if self.is_rnn:
            raise ValueError("text stream requires a transformer decoder")
        return self.decoder.embedding

    def prepare_inputs_for_decoder(self, encoding_phase_outputs: Dict[str, Any],
                                   batch: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for key in self.decoder_input_keys:
            if key in encoding_phase_outputs:
                out[key] = encoding_phase_outputs[key]
            elif key in batch:
                out[key] = batch[key]
            else:
                raise KeyError(f"decoder input `{key}` not found")
        return out

    def decoding_phase(self, input_ids, inputs_for_decoder: Dict[str, Any],
                       last_time_step_logits: bool = False,
                       compute_logits: bool = True,
                       collect_aux: bool = True,
                       attr_input_ids=None, rnn_state=None,
                       schedule_sampling_prob: float = 0.0
                       ) -> Dict[str, Any]:
        """``compute_logits=False`` (the fused-xent training path,
        ``ops/fused_xent.py``, and the fused statistics of NAR decoding)
        skips the vocab projection: the caller takes its statistics from
        ``hidden_states`` and the head's weight, so the ``[B, L, V]``
        logits never exist; a pointer model computes its logits all the
        same, since its ``probs`` need them (as in the JAX package). Given
        the two-stage decoder's list of hidden states, ``logits`` is the
        list of each pass's logits. The pointer then adds ``probs``, which
        replace the softmax of the logits downstream.
        ``collect_aux`` adds the decoder's aux entries (attention
        probabilities, contexts, embeddings) that the decoder-side concept
        losses read. An RNN decoder computes its logits whatever
        ``compute_logits`` says; ``rnn_state`` is the carry its
        ``last_time_step_logits`` step starts from (None: the initial one),
        ``schedule_sampling_prob`` the probability its time loop feeds a
        sampled token in training mode."""
        if self.is_rnn:
            return self._rnn_decoding_phase(
                input_ids, inputs_for_decoder, last_time_step_logits,
                rnn_state, schedule_sampling_prob)
        outputs = self.decoder(input_ids, collect_aux=collect_aux,
                               attr_input_ids=attr_input_ids,
                               **inputs_for_decoder)
        if (not compute_logits and not last_time_step_logits
                and self.pointer is None):
            # the two-stage decoder's hidden_states is a list of passes;
            # the callers take the last entry
            return outputs
        hidden_states = outputs["hidden_states"]
        if last_time_step_logits:
            if isinstance(hidden_states, list):
                hidden_states = hidden_states[-1]
            outputs["logits"] = self.cls_head(hidden_states[:, -1, :])
        elif isinstance(hidden_states, list):
            outputs["logits"] = [self.cls_head(h) for h in hidden_states]
        else:
            outputs["logits"] = self.cls_head(hidden_states)
        if self.pointer is not None:
            outputs.update(self.pointer(
                **{**inputs_for_decoder, **outputs},
                last_time_step_logits=last_time_step_logits))
        return outputs

    def _rnn_decoding_phase(self, input_ids, inputs_for_decoder,
                            last_time_step_logits, rnn_state,
                            schedule_sampling_prob):
        kwargs = {k: v for k, v in inputs_for_decoder.items()
                  if k != "encoder_hidden_states"}
        enc = inputs_for_decoder["encoder_hidden_states"]
        if last_time_step_logits:
            it = input_ids[:, -1] if input_ids.dim() == 2 else input_ids
            out = self.decoder.forward_step(it, enc, rnn_state, **kwargs)
            out["logits"] = self.cls_head(out["hidden_states"])
            return out
        return self.decoder(input_ids, enc, cls_head=self.cls_head,
                            schedule_sampling_prob=schedule_sampling_prob,
                            **kwargs)

    def forward(self, batch: Dict[str, Any], compute_logits: bool = True,
                collect_aux: bool = True,
                schedule_sampling_prob: float = 0.0) -> Dict[str, Any]:
        """feedforward_step (reference ``Framework.py:215-234``). In
        training mode (``model.train()``) every dropout is active and draws
        from the generator given to ``set_dropout_generator``, the
        encoder's BatchNorm moves its running statistics, and an RNN
        decoder feeds sampled tokens at ``schedule_sampling_prob``."""
        encoding_phase_outputs = self.encoding_phase(batch["feats"])
        inputs_for_decoder = self.prepare_inputs_for_decoder(
            encoding_phase_outputs, batch)
        return {**encoding_phase_outputs,
                **self.decoding_phase(batch["input_ids"], inputs_for_decoder,
                                      compute_logits=compute_logits,
                                      collect_aux=collect_aux,
                                      attr_input_ids=batch.get(
                                          "attr_input_ids"),
                                      schedule_sampling_prob=
                                      schedule_sampling_prob)}

    # ------------------------------------------------------------------
    # KV-cached incremental decoding
    # ------------------------------------------------------------------
    def init_decode_state(self, inputs_for_decoder: Dict[str, Any],
                          max_len: int, beam_size: int = 1) -> Dict[str, Any]:
        """``beam_size`` > 1 expects un-enlarged inputs: the self-KV cache is
        laid out at B*beam rows while cross and concept K/V stay at B."""
        enc = inputs_for_decoder["encoder_hidden_states"]
        enc0 = enc[0] if isinstance(enc, (list, tuple)) else enc
        get = inputs_for_decoder.get
        return self.decoder.init_decode_state(
            batch_size=enc0.shape[0] * beam_size, max_len=max_len,
            beam_size=beam_size, encoder_hidden_states=enc,
            semantic_embs=get("semantic_embs"),
            semantic_hidden_states=get("semantic_hidden_states"),
            preds_attr=get("preds_attr"), category=get("category"),
            category_embs=get("category_embs"))

    def decode_step_hidden(self, token_ids, position: int, state):
        """One AR step returning the decoder hidden states [B, H] before the
        vocab projection: the fused head + top-k serving path streams the
        projection itself, so the [B, V] logits are never formed."""
        return self.decoder.decode_step(token_ids, position, state)

    def decode_step(self, token_ids, position: int, state,
                    inputs_for_decoder: Dict[str, Any] = None):
        """One AR step: returns (out [B, V], state, is_prob). A pointer
        model given its (beam-enlarged) ``inputs_for_decoder`` returns
        ``log(probs + 1e-9)`` and ``is_prob`` True, the copy head and the
        log inside the span ``care.pointer``; otherwise ``out`` is the
        logits and ``is_prob`` False. The inputs hold ``ret_input_ids``
        and either the retrieved captions' ``ret_text_embs``, which the
        copy head then projects, or their projections ``ret_k`` /
        ``ret_v`` (``Pointer.project_memory``)."""
        h, state = self.decoder.decode_step(token_ids, position, state)
        logits = self.cls_head(h)
        if self.pointer is None or inputs_for_decoder is None:
            return logits, state, False
        with trace_annotation("care.pointer"):
            probs = self.pointer(hidden_states=h[:, None, :],
                                 logits=logits[:, None, :],
                                 **inputs_for_decoder)["probs"][:, 0, :]
            return torch.log(probs + 1e-9), state, True

    # ------------------------------------------------------------------
    # RNN decoding
    # ------------------------------------------------------------------
    def init_rnn_carry(self, inputs_for_decoder: Dict[str, Any]):
        """The RNN decoder's initial carry from the (beam-enlarged) decoder
        inputs."""
        return self.decoder.init_rnn_state(
            inputs_for_decoder["encoder_hidden_states"])

    def rnn_decode_step(self, token_ids, rnn_state,
                        inputs_for_decoder: Dict[str, Any]):
        """One RNN step: returns (logits [B, V], the new carry)."""
        out = self._rnn_decoding_phase(token_ids, inputs_for_decoder, True,
                                       rnn_state, 0.0)
        return out["logits"], out["decoder_rnn_hidden_states"]

    def project_attribute(self, feats, flag: str):
        """The concept projection of ``flag``, shared with the loss layer
        (the decoder-side concept flags)."""
        return self.predictor.project_attribute(feats, flag)


def build_captioner(opt: dict, device=None, seed: int = 0) -> Captioner:
    """The Captioner for ``opt``, its weights drawn from a
    ``torch.Generator`` seeded with ``seed``, in eval mode, on ``device``
    (``None`` = the CUDA card; raises without one unless ``"cpu"``)."""
    device = resolve_device(device)
    generator = torch.Generator().manual_seed(seed)
    return Captioner(opt, generator).eval().to(device)
