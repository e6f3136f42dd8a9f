"""Attention math as one plain function over ``[B, H, L, Dh]`` tensors, and
the switch to the flash kernel.

The port of ``care_tpu/ops/attention.py`` (reference
``models/components/Attention.py:69-131``): f32 scores, scaled, plus one
additive bias that carries every term (the 0/-1e9 pad or causal mask, the
relative-position bias, then the hybrid bias, in the reference's order),
softmax or sigmoid, dropout on the probabilities in training, ``probs @ v``.
The dense path is plain matrix products, as XLA computes them outside any
kernel in the JAX package. With ``use_flash`` a call that wants no
probabilities back, has no active dropout and takes the softmax goes to
``ops/flash_attention.py`` instead, whose kernel never forms the
``[B, H, Lq, Lk]`` scores; on a CUDA tensor that launches the kernel or
raises, with no way back to the dense path.
"""

import math

import torch

from care_tpu_torch.ops.flash_attention import flash_attention

NEG_INF = -1e9


def dot_product_attention(query, key, value, bias=None,
                          use_sigmoid: bool = False,
                          sigmoid_normalize: bool = False,
                          return_probs: bool = True, dropout=None,
                          use_flash: bool = False):
    """Returns (context [B, H, Lq, Dh] in ``value``'s dtype, probs or None).
    ``dropout``, a module applied to the probabilities before ``probs @ v``,
    is the attention-probability dropout of training; the returned probs
    are the undropped ones."""
    dropping = dropout is not None and dropout.training and dropout.p > 0
    if use_flash and not dropping and not use_sigmoid and not return_probs:
        return flash_attention(query, key, value, bias=bias), None

    scale = 1.0 / math.sqrt(query.shape[-1])
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    if use_sigmoid:
        probs = torch.sigmoid(scores)
        if sigmoid_normalize:
            probs = probs / probs.sum(dim=-1, keepdim=True)
    else:
        probs = torch.softmax(scores, dim=-1)
    dropped = probs if dropout is None else dropout(probs)
    context = torch.matmul(dropped.to(value.dtype), value)
    return context, (probs if return_probs else None)


def relative_position_index(length_q: int, length_k: int, max_len: int,
                            bidirectional: bool = True, device=None):
    """Index matrix [length_q, length_k] into a relative-position embedding
    table of 2 * max_len + 1 rows."""
    rq = torch.arange(length_q, device=device)[:, None]
    rk = torch.arange(length_k, device=device)[None, :]
    hi = max_len if bidirectional else 0
    return torch.clamp(rk - rq, -max_len, hi) + max_len
