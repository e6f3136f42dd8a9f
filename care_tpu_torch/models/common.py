"""Shared building blocks: the Dense convention, its init, activations.

Weight-init parity with the reference (``models/Framework.py:115-134``) and
the JAX package: xavier-uniform for every Linear weight and embedding
table, zero biases, LayerNorm weight 1 / bias 0, the PAD embedding row
zeroed. Init draws from the ``torch.Generator`` the model is built with.
"""

import torch
from torch import nn

from care_tpu_torch import constants


def dense(dim_in: int, dim_out: int, generator: torch.Generator,
          bias: bool = True) -> nn.Linear:
    """``nn.Linear`` with the JAX package's ``Dense`` init."""
    layer = nn.Linear(dim_in, dim_out, bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


def xavier_param(shape, generator: torch.Generator,
                 zero_pad_row: bool = False) -> nn.Parameter:
    """A xavier-uniform table, optionally with the PAD row zeroed."""
    table = torch.empty(shape)
    nn.init.xavier_uniform_(table, generator=generator)
    if zero_pad_row:
        table[constants.PAD] = 0.0
    return nn.Parameter(table)


ACTIVATIONS = {
    "relu": torch.relu,
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "linear": lambda x: x,
    "sigmoid": torch.sigmoid,
    "leakyrelu": lambda x: nn.functional.leaky_relu(x, 0.01),
}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"unknown activation `{name}`")
    return ACTIVATIONS[name]


def unsupported(option: str, value=None):
    """The error for an option this slice of the port does not implement."""
    shown = option if value is None else f"{option}={value!r}"
    return NotImplementedError(
        f"care_tpu_torch does not implement {shown} yet (see ROADMAP.md)")
