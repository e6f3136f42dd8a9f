"""Attention math as one plain function over ``[B, H, L, Dh]`` tensors.

The port of ``care_tpu/ops/attention.py:dot_product_attention`` (reference
``models/components/Attention.py:69-131``): f32 scores, scaled, plus one
additive bias that carries every term (the 0/-1e9 pad or causal mask, then
the hybrid bias, in the reference's order), softmax, dropout on the
probabilities in training, ``probs @ v``. Plain
matrix products, as XLA computes them outside any kernel in the JAX
package; the flash kernel that the JAX package uses at 512 keys and more
is not ported yet.
"""

import math

import torch

NEG_INF = -1e9


def dot_product_attention(query, key, value, bias=None,
                          return_probs: bool = True, dropout=None):
    """Returns (context [B, H, Lq, Dh] in ``value``'s dtype, probs or None).
    ``dropout``, a module applied to the probabilities before ``probs @ v``,
    is the attention-probability dropout of training; the returned probs
    are the undropped ones."""
    scale = 1.0 / math.sqrt(query.shape[-1])
    scores = torch.matmul(query.float(), key.float().transpose(-1, -2)) * scale
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    dropped = probs if dropout is None else dropout(probs)
    context = torch.matmul(dropped.to(value.dtype), value)
    return context, (probs if return_probs else None)
