"""Megatron's tensor-parallel operators over a mesh's ``model`` axis.

In the JAX package XLA inserts these collectives from the shardings; in
the port they are written out. An activation is either *replicated* (the
same on every process of a model group, its gradient too) or *local* (this
process's block along the last dim: the heads of a column-parallel
projection, a shard of the vocabulary or of the concepts):

* ``copy_to_model``: identity forward, all-reduce of the gradient backward
  (a replicated input entering a column-parallel layer, whose gradient
  each process holds only in part);
* ``reduce_from_model``: all-reduce forward, identity backward (the
  partial products of a row-parallel layer);
* ``gather_from_model``: the whole tensor from the blocks forward, this
  process's block of the gradient backward (a column-parallel output
  consumed whole: the vocab logits, the concept scores, the attention
  probabilities of a head-split layer);
* ``local_block``: this process's block of a replicated tensor (a per-head
  bias, the bias of a head split by rows), through ``copy_to_model`` so
  that its gradient sums over the blocks.

Every collective is an all-reduce: gloo offers only it and broadcast on
CUDA tensors, and a gather is an all-reduce of this process's block into
zero-filled slots (adding zeros is exact). On an axis of size 1 each
operator is the identity and no collective runs.

``column`` / ``row`` / ``linear`` apply a ``Linear`` whose weight may be
split (``parallel/mesh.py:shard_params`` records which); a row-parallel
layer adds its replicated bias once, after the reduce. ``all_reduce_sum``
(forward and backward both sum) carries the data axis's BatchNorm
statistics.
"""

from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from care_tpu_torch.parallel.mesh import Axis


def axis_active(ax: Optional[Axis]) -> bool:
    """Whether collectives run over ``ax`` (an axis of more than one)."""
    return ax is not None and ax.size > 1


def all_gather_slots(t: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The blocks of every process along ``dim`` side by side."""
    if not axis_active(ax):
        return t
    dim = dim % t.dim()
    shape = list(t.shape)
    n = shape[dim]
    shape[dim] = n * ax.size
    out = t.new_zeros(shape)
    out.narrow(dim, ax.rank * n, n).copy_(t)
    dist.all_reduce(out, group=ax.group())
    return out


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ax.group())
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=ax.group())
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, ax):
        ctx.dim, ctx.ax, ctx.n = dim, ax, x.shape[dim]
        return all_gather_slots(x.contiguous(), dim, ax)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.ax.rank * ctx.n, ctx.n), None, None)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ax):
        ctx.ax = ax
        x = x.contiguous().clone()
        dist.all_reduce(x, group=ax.group())
        return x

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.ax.group())
        return g, None


def copy_to_model(x, ax: Optional[Axis]):
    return _CopyToModel.apply(x, ax) if axis_active(ax) else x


def reduce_from_model(x, ax: Optional[Axis]):
    return _ReduceFromModel.apply(x, ax) if axis_active(ax) else x


def gather_from_model(x, ax: Optional[Axis], dim: int = -1):
    return (_GatherFromModel.apply(x, dim % x.dim(), ax) if axis_active(ax)
            else x)


def all_reduce_sum(x, ax: Optional[Axis]):
    """Sum over the axis, forward and backward (a statistic every process
    normalises by, so every process's loss depends on every block)."""
    return _AllReduceSum.apply(x, ax) if axis_active(ax) else x


def local_block(x, ax: Optional[Axis], dim: int):
    """This process's block along ``dim`` of the replicated ``x``."""
    if not axis_active(ax):
        return x
    n = x.shape[dim] // ax.size
    return copy_to_model(x, ax).narrow(dim, ax.rank * n, n)


def axis_of(layer: nn.Module) -> Optional[Axis]:
    ax = getattr(layer, "_tp_axis", None)
    return ax if axis_active(ax) else None


def split_dim(layer: nn.Module, attr: str = "weight") -> Optional[int]:
    if axis_of(layer) is None:
        return None
    return getattr(layer, "_tp_split", {}).get(attr)


def _promoted_linear(x, w, b):
    """``Dense``'s rule: compute in the promoted dtype of input and
    parameters."""
    dtype = torch.promote_types(x.dtype, w.dtype)
    return F.linear(x.to(dtype), w.to(dtype),
                    None if b is None else b.to(dtype))


def column(layer: nn.Module, x):
    """(``layer(x)``, the model axis when the result is local, else None):
    a weight split by rows gives this process's block of the outputs, its
    bias cut to the same block (split itself, or replicated and taken
    here)."""
    ax = axis_of(layer)
    if ax is None or split_dim(layer) != 0:
        return layer(x), None
    b = layer.bias
    if b is not None and split_dim(layer, "bias") is None:
        b = local_block(b, ax, 0)
    return _promoted_linear(copy_to_model(x, ax), layer.weight, b), ax


def row(layer: nn.Module, x, local: Optional[Axis]):
    """``layer`` applied to ``x``, local over the axis ``local`` (a
    column-parallel output) or replicated (None): a weight split by
    columns multiplies this process's block and the partial products are
    summed over the model group before the bias; an unsplit layer takes the
    whole input."""
    ax = axis_of(layer)
    if ax is None or split_dim(layer) != 1:
        return layer(gather_from_model(x, local) if local else x)
    if local is None:
        x = local_block(x, ax, x.dim() - 1)
    y = reduce_from_model(_promoted_linear(x, layer.weight, None), ax)
    return y if layer.bias is None else y + layer.bias.to(y.dtype)


def column_whole(layer: nn.Module, x):
    """``layer(x)`` whole on every process: a row-split weight's block of
    outputs gathered over the model group (the vocab logits, the concept
    scores)."""
    y, ax = column(layer, x)
    return gather_from_model(y, ax) if ax else y


def all_reduce_grads_mean(params, ax: Optional[Axis]) -> None:
    """Average the gradients of ``params`` over the data axis in one
    flat all-reduce; nothing runs (and nothing rounds) on an axis of one."""
    if not axis_active(ax):
        return
    grads = [p.grad for p in params]
    flat = torch._utils._flatten_dense_tensors(grads)
    dist.all_reduce(flat, group=ax.group())
    flat.div_(ax.size)
    for g, r in zip(grads, torch._utils._unflatten_dense_tensors(flat,
                                                                  grads)):
        g.copy_(r)
