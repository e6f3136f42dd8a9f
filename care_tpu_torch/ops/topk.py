"""Exact top-k with ``lax.top_k``'s tie order.

``jax.lax.top_k`` returns equal values lowest index first, and the beam
search's token choices depend on that order wherever scores tie.
``torch.topk`` promises no order among ties, so the port takes the first
``k`` entries of a stable descending sort instead: a stable sort keeps equal
values in index order. The port only calls it on narrow axes (the K*K beam
candidates, the concept scores), where a sort costs nothing.
"""

import torch


def top_k(x: torch.Tensor, k: int):
    """x: [..., n] -> (values [..., k], indices [..., k] int64), largest
    first, equal values lowest index first."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]
