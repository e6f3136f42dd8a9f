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


class Dropout(nn.Module):
    """Inverted dropout whose keep mask comes from an explicit
    ``torch.Generator`` (``F.dropout`` takes none), so that a training run
    repeats from its seed whatever else draws random numbers. Active only
    in training mode; ``generator`` None draws from torch's default
    generator of the tensor's device. ``set_dropout_generator`` hands one
    generator to every ``Dropout`` of a model."""

    def __init__(self, p: float):
        super().__init__()
        if not 0.0 <= p < 1.0:
            raise ValueError(f"dropout probability {p} must lie in [0, 1)")
        self.p = p
        self.generator = None

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator,
                          device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)

    def extra_repr(self) -> str:
        return f"p={self.p}"


def set_dropout_generator(model: nn.Module, generator) -> None:
    """Every ``Dropout`` of ``model`` draws from ``generator`` from now on
    (a ``torch.Generator`` on the model's device, or None)."""
    for module in model.modules():
        if isinstance(module, Dropout):
            module.generator = generator


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
