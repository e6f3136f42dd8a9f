"""Shared building blocks: the Dense convention, its init, activations,
the semantic-conditioned ``CompositionalLinear``.

Weight-init parity with the reference (``models/Framework.py:115-134``) and
the JAX package: xavier-uniform for every Linear weight and embedding
table, zero biases, LayerNorm weight 1 / bias 0, the PAD embedding row
zeroed. Init draws from the ``torch.Generator`` the model is built with.
"""

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch import constants
from care_tpu_torch.parallel import tensor_parallel as tp


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


class FlaxBatchNorm(nn.Module):
    """flax's ``nn.BatchNorm`` over the channel axis ``dim`` of its input,
    under flax's names: parameters ``scale`` and ``bias``, running
    statistics ``mean`` and ``var`` (``models/weights.py`` carries them as
    ``batch_stats``). It normalises as flax does, ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``. ``frozen`` (the CNN towers'
    ``use_running_average=True``) always takes the running statistics,
    whatever ``train()`` says. Otherwise training takes the batch's mean
    and its *biased* variance ``E[x^2] - E[x]^2`` (clipped at 0, in f32)
    and moves the running ones by ``momentum`` as flax does:
    ``new = momentum * old + (1 - momentum) * batch``; torch's
    ``BatchNorm`` would move them by the unbiased variance. On a mesh's
    data axis (``_data_axis``, set by ``parallel/mesh.py:shard_params``) the
    sums are taken over the whole global batch, as the JAX package's
    statistics are under its mesh."""

    FLAX_BATCH_STATS = True
    SYNC_BATCH_STATS = True
    _data_axis = None

    def __init__(self, features: int, eps: float = 1e-5,
                 momentum: float = 0.99, frozen: bool = False, dim: int = 1):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.eps, self.momentum, self.frozen, self.dim = (eps, momentum,
                                                          frozen, dim)

    def forward(self, x):
        shape = [1] * x.dim()
        shape[self.dim] = -1
        if self.frozen or not self.training:
            mean, var = self.mean, self.var
        else:
            axes = [d for d in range(x.dim()) if d != self.dim % x.dim()]
            x32 = x.float()
            if tp.axis_active(self._data_axis):
                ax = self._data_axis
                n = (x32.numel() // x32.shape[self.dim]) * ax.size
                sums = tp.all_reduce_sum(torch.stack(
                    [x32.sum(dim=axes), x32.square().sum(dim=axes)]), ax)
                mean = sums[0] / n
                var = torch.clamp(sums[1] / n - mean.square(), min=0.0)
            else:
                mean = x32.mean(dim=axes)
                var = torch.clamp(x32.square().mean(dim=axes)
                                  - mean.square(), min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return (x - mean.reshape(shape)) * mul.reshape(shape) \
            + self.bias.reshape(shape)

    def extra_repr(self) -> str:
        return (f"{self.scale.numel()}, eps={self.eps}, momentum="
                f"{self.momentum}, frozen={self.frozen}")


def lecun_normal_(tensor, fan_in: int, generator: torch.Generator):
    """flax's default kernel init, in place: a normal of variance
    1 / fan_in, truncated at two standard deviations."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(tensor, std=std, a=-2 * std, b=2 * std,
                              generator=generator)
    return tensor


def flax_init_(layer: nn.Module, generator: torch.Generator) -> nn.Module:
    """A ``Linear`` or ``Conv`` with flax's default init, in place: its
    weight lecun-normal over its fan-in, its bias (if any) zero."""
    lecun_normal_(layer.weight, layer.weight[0].numel(), generator)
    if layer.bias is not None:
        with torch.no_grad():
            layer.bias.zero_()
    return layer


@torch.no_grad()
def encode_in_chunks(model: nn.Module, inputs, batch_size: int,
                     dtype: torch.dtype):
    """``model`` over the numpy array ``inputs`` in chunks of
    ``batch_size`` rows on the model's device, the chunks cast to
    ``dtype``; numpy f32 out, the chunks' outputs concatenated."""
    device = next(model.parameters()).device
    outs = []
    for i in range(0, inputs.shape[0], batch_size):
        chunk = torch.as_tensor(np.ascontiguousarray(
            inputs[i:i + batch_size]), device=device).to(dtype)
        outs.append(model(chunk).float().cpu().numpy())
    return np.concatenate(outs, axis=0)


def dense(dim_in: int, dim_out: int, generator: torch.Generator,
          bias: bool = True) -> Dense:
    """``Dense`` with the JAX package's ``Dense`` init."""
    layer = Dense(dim_in, dim_out, bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(layer.weight, generator=generator)
        if bias:
            layer.bias.zero_()
    return layer


class LazyDense(nn.LazyLinear):
    """``dense`` whose input width comes from its first call, as flax's
    ``Dense`` takes it from its first input (or from the weights that
    ``models/weights.py`` carries in, which fix it first). Until then its
    parameters are uninitialized; then it becomes a ``Dense``, its weight
    xavier-uniform from a seed drawn from ``generator`` at construction."""

    cls_to_become = Dense

    def __init__(self, dim_out: int, generator: torch.Generator):
        super().__init__(dim_out)
        self.init_seed = int(torch.randint(2 ** 62, (1,),
                                           generator=generator))

    def reset_parameters(self):
        if self.has_uninitialized_params() or not hasattr(self, "init_seed"):
            return
        weight = torch.empty(self.weight.shape)
        nn.init.xavier_uniform_(
            weight, generator=torch.Generator().manual_seed(self.init_seed))
        with torch.no_grad():
            self.weight.copy_(weight)
            self.bias.zero_()


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
