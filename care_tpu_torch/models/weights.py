"""Carry the JAX package's parameters into the port.

``params_from_jax(model, params)`` fills a port ``Captioner`` from a
``care_tpu`` Captioner's ``variables["params"]``, a nested dict of arrays.
The port's submodules carry the flax tree's names, so the walk is
mechanical: a ``Linear``'s ``weight`` is the flax ``kernel`` transposed
([in, out] -> [out, in]), a ``Conv2d`` / ``Conv3d``'s ``weight`` is the
flax ``kernel`` [*window, in, out] laid out as torch's [out, in, *window],
a ``LayerNorm``'s ``weight`` is its ``scale``, and every other parameter
(embedding tables, the hybrid bias, the CLIP attention's
``[width, heads, head_dim]`` kernels) keeps its name and shape. Arrays are
copied, never aliased.

``variables_from_jax(model, variables)`` takes the whole variables: the
``params`` and the BatchNorm running statistics ``batch_stats`` (``mean``
and ``var`` under the flax path of each ``BatchNorm1d``, whose ``weight``
is the flax ``scale``, and of each ``FlaxBatchNorm``, which keeps flax's
names); ``variables_to_jax(model)`` is its inverse.

``params_to_jax(model)`` and ``grads_to_jax(model)`` go the other way: the
port's parameters, or their ``.grad``s, as a nested dict of numpy arrays
under the flax tree's names and layouts, so that gradients and updated
parameters can be compared leaf by leaf. ``jax_leaf_key`` is the one name
map all three share; the optimizer's path filters use it too.
"""

import numpy as np
import torch
from torch import nn


def flat_leaves(tree, prefix=()):
    """(path tuple, leaf) of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def jax_leaf_key(model: nn.Module, name: str):
    """(flax path as a tuple, relaid?) of the port parameter ``name`` (a
    key of ``model.named_parameters()``): relaid leaves go through
    ``from_flax_layout`` / ``to_flax_layout``."""
    *mod_path, attr = name.split(".")
    module = model.get_submodule(".".join(mod_path))
    if (isinstance(module, (nn.Linear, nn.Conv2d, nn.Conv3d))
            and attr == "weight"):
        return tuple(mod_path) + ("kernel",), True
    if (isinstance(module, (nn.LayerNorm, nn.BatchNorm1d))
            and attr == "weight"):
        return tuple(mod_path) + ("scale",), False
    return tuple(mod_path) + (attr,), False


def from_flax_layout(value: np.ndarray) -> np.ndarray:
    """A flax kernel [*window, in, out] (a ``Dense``'s [in, out]) in the
    layout of torch's weight, [out, in, *window]."""
    n = value.ndim
    return np.ascontiguousarray(
        value.transpose((n - 1, n - 2) + tuple(range(n - 2))))


def to_flax_layout(value: np.ndarray) -> np.ndarray:
    """The inverse of ``from_flax_layout``."""
    n = value.ndim
    return np.ascontiguousarray(
        value.transpose(tuple(range(2, n)) + (1, 0)))


def params_from_jax(model: nn.Module, params: dict,
                    cut=None) -> nn.Module:
    """Copy ``params`` into ``model`` in place and return it. Raises on a
    shape mismatch, on a port parameter with no JAX leaf, and on a JAX leaf
    that no port parameter takes. ``cut(name, whole tensor)`` gives the
    part a parameter holds (a model split over a mesh:
    ``parallel/mesh.py:local_cut``); default: the whole."""
    leaves = dict(flat_leaves(params))
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            key, transpose = jax_leaf_key(model, name)
            if key not in leaves:
                raise KeyError(f"no JAX parameter {'/'.join(key)} for {name}")
            value = np.array(leaves[key], dtype=np.float32)
            if transpose:
                value = from_flax_layout(value)
            if isinstance(param, nn.parameter.UninitializedParameter):
                _fix_lazy_width(model, name, value)
            value = torch.from_numpy(value)
            if cut is not None:
                value = cut(name, value)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: port shape {tuple(param.shape)} "
                                 f"!= JAX shape {tuple(value.shape)}")
            param.copy_(value)
            used.add(key)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"JAX parameters the port does not take: {unused}")
    return model


def _fix_lazy_width(model: nn.Module, name: str, value) -> None:
    """Give the lazy ``Linear`` that holds ``name`` its input width from
    the carried weight ``value`` (``[out, in]``), as its first call would:
    its parameters become ordinary ones of that width."""
    module = model.get_submodule(name.rsplit(".", 1)[0])
    if not isinstance(module, nn.LazyLinear) or value.ndim != 2:
        raise ValueError(f"{name} is uninitialized and takes no width from "
                         f"a JAX leaf of shape {value.shape}")
    module.initialize_parameters(torch.empty(0, value.shape[1]))


def _to_jax_tree(model: nn.Module, pick) -> dict:
    tree: dict = {}
    for name, param in model.named_parameters():
        key, transpose = jax_leaf_key(model, name)
        if not key[:-1]:
            raise KeyError(f"port parameter {name} has no flax name")
        if isinstance(param, nn.parameter.UninitializedParameter):
            raise ValueError(f"{name} has no width yet: its lazy layer "
                             f"takes it from its first call")
        tensor = pick(name, param)
        value = tensor.detach().to("cpu", torch.float32).numpy().copy()
        node = tree
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = to_flax_layout(value) if transpose else value
    return tree


def params_to_jax(model: nn.Module, values: dict = None) -> dict:
    """The port's parameters as the flax ``params`` tree (numpy copies,
    Linear weights transposed back to ``[in, out]`` kernels). Raises on a
    parameter that has no flax name (one held by the model itself rather
    than a named submodule). ``values`` (parameter name -> tensor of that
    parameter's shape) gives the tree of other values under the model's
    names, say a mean teacher's copy of the parameters."""
    if values is None:
        return _to_jax_tree(model, lambda name, param: param)
    return _to_jax_tree(model, lambda name, param: values[name])


def grads_to_jax(model: nn.Module) -> dict:
    """The parameters' ``.grad``s in the same tree; raises on a parameter
    without a gradient."""
    def pick(name, param):
        if param.grad is None:
            raise ValueError(f"{name} has no gradient")
        return param.grad
    return _to_jax_tree(model, pick)


def batch_stats_leaves(model: nn.Module):
    """(flax ``batch_stats`` path tuple, module, buffer name) of every
    running statistic of ``model``: ``mean`` and ``var`` of each
    ``BatchNorm1d`` (its ``running_mean`` / ``running_var``) and of each
    module that keeps them under flax's names (``FLAX_BATCH_STATS``)."""
    for name, module in model.named_modules():
        path = tuple(name.split("."))
        if isinstance(module, nn.BatchNorm1d):
            yield path + ("mean",), module, "running_mean"
            yield path + ("var",), module, "running_var"
        elif getattr(module, "FLAX_BATCH_STATS", False):
            yield path + ("mean",), module, "mean"
            yield path + ("var",), module, "var"


def variables_from_jax(model: nn.Module, variables: dict,
                       cut=None) -> nn.Module:
    """``params_from_jax`` of ``variables["params"]`` (``cut`` as there),
    then the running mean and variance of every ``BatchNorm1d`` from
    ``variables["batch_stats"]``. Raises, as ``params_from_jax`` does, on
    a shape mismatch, a running statistic with no JAX leaf, a JAX leaf no
    module takes, and a collection other than these two."""
    other = sorted(set(variables) - {"params", "batch_stats"})
    if other:
        raise KeyError(f"JAX collections the port does not take: {other}")
    params_from_jax(model, variables["params"], cut)
    leaves = dict(flat_leaves(variables.get("batch_stats", {})))
    used = set()
    with torch.no_grad():
        for key, module, attr in batch_stats_leaves(model):
            buf = getattr(module, attr)
            if key not in leaves:
                raise KeyError(f"no JAX batch_stats {'/'.join(key)}")
            value = np.array(leaves[key], dtype=np.float32)
            if tuple(value.shape) != tuple(buf.shape):
                raise ValueError(f"{'/'.join(key)}: port shape "
                                 f"{tuple(buf.shape)} != JAX shape "
                                 f"{tuple(value.shape)}")
            buf.copy_(torch.from_numpy(value))
            used.add(key)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"JAX batch_stats the port does not take: {unused}")
    return model


def variables_to_jax(model: nn.Module, values: dict = None) -> dict:
    """The port's parameters and BatchNorm running statistics as the flax
    variables tree ``{"params": ..., "batch_stats": ...}`` (no
    ``batch_stats`` without a BatchNorm); ``values`` as in
    ``params_to_jax``."""
    out = {"params": params_to_jax(model, values)}
    for key, module, attr in batch_stats_leaves(model):
        node = out.setdefault("batch_stats", {})
        for part in key[:-1]:
            node = node.setdefault(part, {})
        node[key[-1]] = getattr(module, attr).detach().to(
            "cpu", torch.float32).numpy().copy()
    return out
