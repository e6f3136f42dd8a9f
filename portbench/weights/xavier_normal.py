"""The model's weights (``"weights": "xavier_normal"``), made by the
benchmark from the seed on the device.

One draw of standard normals for all parameters (a ``torch.Generator`` on
the device), cut into the parameters by their names and scaled as the
model's initialisation scales them: a matrix or table by the xavier
standard deviation of its shape, a LayerNorm gain about 1, every bias and
the concept-slot hybrid bias small but not zero, so that a mixed-up
parameter shows in the comparison. The program and the reference are both
given these tensors.
"""

import math

import torch


def _scale(name: str, shape) -> tuple:
    """(mean, standard deviation) of a parameter's entries."""
    if name.endswith("LayerNorm.weight") or name.endswith(".ln.weight"):
        return 1.0, 0.1
    if name.endswith("LayerNorm.bias") or name.endswith(".ln.bias"):
        return 0.0, 0.1
    if name.endswith("hybrid_bias"):
        return 0.0, 0.1
    if len(shape) == 1:
        return 0.0, 0.02
    return 0.0, math.sqrt(2.0 / (shape[0] + shape[1]))


def make(shapes: dict, seed: int, device, model: dict = None) -> dict:
    """Parameter name -> f32 tensor on ``device``, from ``seed``; the
    configuration's ``model`` sizes are not needed here."""
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(s) for s in shapes.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        mean, sd = _scale(name, shape)
        out[name] = flat[at:at + n].view(shape).mul(sd).add_(mean)
        at += n
    return out
