"""Shared building blocks: the Dense convention, its init, activations,
the semantic-conditioned ``CompositionalLinear``.

Weight-init parity with the reference (``models/Framework.py:115-134``) and
the JAX package: xavier-uniform for every Linear weight and embedding
table, zero biases, LayerNorm weight 1 / bias 0, the PAD embedding row
zeroed. Init draws from the ``torch.Generator`` the model is built with.
"""

import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch import constants


class Dense(nn.Linear):
    """``nn.Linear`` that computes in the promoted dtype of its input and
    its parameters, as flax's ``Dense`` does: a bf16 layer applied to f32
    inputs computes in f32 (the half-precision decode of a model whose
    concept vector stays f32, ``decoding/translator.py``)."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` with flax's dtype rule: the output takes the
    promoted dtype of the input and the parameters; the statistics are
    taken in f32 whatever the dtype (torch's bf16 kernels accumulate in
    f32, flax promotes to f32)."""

    def forward(self, x):
        if x.dtype == self.weight.dtype:
            return super().forward(x)
        dtype = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dtype), self.normalized_shape,
                            self.weight.to(dtype), self.bias.to(dtype),
                            self.eps)


def dense(dim_in: int, dim_out: int, generator: torch.Generator,
          bias: bool = True) -> Dense:
    """``Dense`` with the JAX package's ``Dense`` init."""
    layer = Dense(dim_in, dim_out, bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class CompositionalLinear(nn.Module):
    """Low-rank semantic-conditioned linear map ``A(B(sem) * C(x)) + b``
    (reference ``models/components/basic.py:4-19``), the "semantic
    composition" GSG ablation's projection: ``linear_b`` takes the concept
    distribution [B, dim_semantic], ``linear_c`` the input, ``linear_a``
    their product, all bias-free; ``bias`` [dim_hidden] is added last."""

    def __init__(self, dim_hidden: int, dim_factor: int, dim_semantic: int,
                 dim_input: int, generator: torch.Generator):
        super().__init__()
        self.linear_b = dense(dim_semantic, dim_factor, generator, bias=False)
        self.linear_c = dense(dim_input, dim_factor, generator, bias=False)
        self.linear_a = dense(dim_factor, dim_hidden, generator, bias=False)
        self.bias = nn.Parameter(torch.zeros(dim_hidden))

    def forward(self, x, semantic_input):
        out_b = self.linear_b(semantic_input)
        if x.dim() == 3 and out_b.dim() == 2:
            out_b = out_b[:, None, :]
        out = self.linear_a(out_b * self.linear_c(x))
        return out + self.bias


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
    """Every ``Dropout`` of ``model``, and every other module that draws in
    training (its ``draws_in_training`` is True: the concept detector's
    sparse frame sampling), draws from ``generator`` from now on (a
    ``torch.Generator`` on the model's device, or None)."""
    for module in model.modules():
        if isinstance(module, Dropout) or getattr(module,
                                                  "draws_in_training", False):
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
