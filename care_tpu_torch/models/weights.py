"""Carry the JAX package's parameters into the port.

``params_from_jax(model, params)`` fills a port ``Captioner`` from a
``care_tpu`` Captioner's ``variables["params"]``, a nested dict of arrays.
The port's submodules carry the flax tree's names, so the walk is
mechanical: a ``Linear``'s ``weight`` is the flax ``kernel`` transposed
([in, out] -> [out, in]), a ``LayerNorm``'s ``weight`` is its ``scale``,
and every other parameter (embedding tables, the hybrid bias) keeps its
name and shape. Arrays are copied, never aliased.
"""

import numpy as np
import torch
from torch import nn


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(model: nn.Module, params: dict) -> nn.Module:
    """Copy ``params`` into ``model`` in place and return it. Raises on a
    shape mismatch, on a port parameter with no JAX leaf, and on a JAX leaf
    that no port parameter takes."""
    leaves = dict(_flat(params))
    used = set()
    with torch.no_grad():
        for name, param in model.named_parameters():
            *mod_path, attr = name.split(".")
            module = model.get_submodule(".".join(mod_path))
            jax_attr, transpose = attr, False
            if isinstance(module, nn.Linear) and attr == "weight":
                jax_attr, transpose = "kernel", True
            elif isinstance(module, nn.LayerNorm) and attr == "weight":
                jax_attr = "scale"
            key = tuple(mod_path) + (jax_attr,)
            if key not in leaves:
                raise KeyError(f"no JAX parameter {'/'.join(key)} for {name}")
            value = np.array(leaves[key], dtype=np.float32)
            if transpose:
                value = np.ascontiguousarray(value.T)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(f"{name}: port shape {tuple(param.shape)} "
                                 f"!= JAX shape {tuple(value.shape)}")
            param.copy_(torch.from_numpy(value))
            used.add(key)
    unused = sorted("/".join(k) for k in leaves if k not in used)
    if unused:
        raise KeyError(f"JAX parameters the port does not take: {unused}")
    return model
