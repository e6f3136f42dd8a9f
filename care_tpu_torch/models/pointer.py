"""Pointer-generator copy head over the retrieved captions.

Port of ``care_tpu/models/pointer.py`` (reference ``models/Pointer.py:18-74``):
a one-head attention of the decoder states over the retrieved captions'
token embeddings (no output dense, no LN, no skip), the copy gate
``p_copy = copy_scale * sigmoid(Wq h + Wc ctx)``, the generator mass
``(1 - p_copy) * softmax(logits)``, the copy mass ``p_copy * attention``
added onto the vocabulary at the retrieved ids, then the mean over the R
retrievals. The resulting ``probs`` replace ``softmax(logits)`` in the loss
and in the decode step.

The [B, R, T, V] form is kept as the JAX package computes it. The copy
mass is added by :func:`copy_scatter`, which repeats bit for bit on the
card: retrieved captions repeat words, and an accumulating scatter
(``scatter_add_``, ``index_add_``) adds equal ids in an order that changes
from run to run there.
"""

from typing import Any, Dict

import torch
from torch import nn

from care_tpu_torch import constants
from care_tpu_torch.models.common import dense
from care_tpu_torch.models.layers import MultiHeadAttention, merge_heads
from care_tpu_torch.ops.attention import NEG_INF, dot_product_attention


class _CopyScatter(torch.autograd.Function):
    """``base`` [N, V] plus ``src`` [N, S] added at the ids ``ids`` [N, S]
    (repeats allowed), with no accumulating write. Each row's equal ids
    are summed in one fixed order (a masked sum over the row's S
    positions), every position takes the value of its id's first position,
    and a plain ``scatter_`` writes them: equal ids write equal bits. The
    backward is the gradient itself for ``base`` and a gather for
    ``src``."""

    @staticmethod
    def forward(ctx, base, ids, src):
        same = ids[:, :, None] == ids[:, None, :]                # [N, S, S]
        total = (same.to(src.dtype) * src[:, None, :]).sum(dim=-1)
        # argmax gives the first of the maximal entries: the id's first
        # position, so all positions of an id carry the same value
        first = same.to(torch.uint8).argmax(dim=-1)
        values = (base.gather(1, ids) + total.to(base.dtype)).gather(1, first)
        ctx.save_for_backward(ids)
        return base.clone().scatter_(1, ids, values)

    @staticmethod
    def backward(ctx, grad):
        ids, = ctx.saved_tensors
        return grad, None, grad.gather(1, ids)


def copy_scatter(base, ids, src):
    """``base`` [N, V] with ``src`` [N, S] added at ``ids`` [N, S], the
    result of ``base.clone().scatter_add_(1, ids, src)`` up to rounding,
    repeating bit for bit on every device."""
    return _CopyScatter.apply(base, ids.long(), src)


class Pointer(nn.Module):
    """The copy head. Submodules carry the flax tree's names:
    ``attention.{query,key,value}``, ``Wq``, ``Wc``."""

    def __init__(self, opt: dict, generator: torch.Generator):
        super().__init__()
        D = opt["dim_hidden"]
        self.attention = MultiHeadAttention(
            D, 1, 0.0, opt.get("layer_norm_eps", 1e-12), generator,
            has_ln=False, skip_connection=False, projections_only=True)
        self.Wq = dense(D, 1, generator)
        self.Wc = dense(D, 1, generator)
        self.copy_scale = opt.get("copy_scale", 1)

    def forward(self, hidden_states, ret_text_embs, ret_input_ids, logits,
                last_time_step_logits: bool = False,
                **unused) -> Dict[str, Any]:
        """``hidden_states`` [B, T, D]; ``ret_text_embs`` [B, R, S, D];
        ``ret_input_ids`` [B, R, S]; ``logits`` [B, T, V], or [B, V] of the
        last position with ``last_time_step_logits``. Returns {"probs":
        [B, T, V]} ([B, V] with ``last_time_step_logits``)."""
        if last_time_step_logits:
            hidden_states = hidden_states[:, -1:, :]
        if ret_input_ids.dim() != 3 or ret_text_embs.dim() != 4:
            raise ValueError(f"retrieved ids {tuple(ret_input_ids.shape)} / "
                             f"embeddings {tuple(ret_text_embs.shape)} are "
                             f"not [B, R, S] / [B, R, S, D]")
        bsz, n_retrieval, seq_len = ret_input_ids.shape
        T, d = hidden_states.shape[1], hidden_states.shape[-1]
        hs = hidden_states[:, None].expand(bsz, n_retrieval, T, d).reshape(
            bsz * n_retrieval, T, d)
        embs = ret_text_embs.reshape(bsz * n_retrieval, seq_len, -1)
        ids_flat = ret_input_ids.reshape(bsz * n_retrieval, seq_len)
        pad_bias = torch.where(ids_flat == constants.PAD, NEG_INF, 0.0)
        pad_bias = pad_bias[:, None, None, :].float()

        q = self.attention.project_q(hs)
        k, v = self.attention.project_kv(embs)
        ctx_h, probs = dot_product_attention(q, k, v, bias=pad_bias,
                                             return_probs=True)
        context = merge_heads(ctx_h)                       # [B*R, T, D]

        p_copy = self.copy_scale * torch.sigmoid(self.Wq(hs)
                                                 + self.Wc(context))
        p_copy = p_copy.reshape(bsz, n_retrieval, T, 1)
        attn = probs.mean(dim=1).reshape(bsz, n_retrieval, T, seq_len)
        ret_probs = p_copy * attn                           # [B, R, T, S]

        base = (logits[:, None, None, :] if last_time_step_logits
                else logits[:, None, :, :])
        vocab = logits.shape[-1]
        gen = (1 - p_copy) * torch.softmax(base, dim=-1)  # [B, R, T, V]
        ids = ret_input_ids[:, :, None, :].expand(bsz, n_retrieval, T,
                                                  seq_len)
        rows = bsz * n_retrieval * T
        out = copy_scatter(gen.reshape(rows, vocab),
                           ids.reshape(rows, seq_len),
                           ret_probs.reshape(rows, seq_len))
        out = out.reshape(bsz, n_retrieval, T, vocab).mean(dim=1)
        if last_time_step_logits:
            out = out[:, 0]
        return {"probs": out}


def get_pointer(opt: dict, generator: torch.Generator):
    """The copy head of ``opt["pointer"]`` (None without one)."""
    name = opt.get("pointer")
    if name is None:
        return None
    if name != "Pointer":
        raise ValueError(f"unknown pointer `{name}`")
    return Pointer(opt, generator)
