"""The weights of models with BatchNorm (``"weights":
"xavier_normal_bn"``), made by the benchmark from the seed on the device:
``xavier_normal``'s draws, with a BatchNorm's entries drawn as its
statistics need.

One draw of standard normals for all entries (a ``torch.Generator`` on the
device), cut into the entries by their names, as ``xavier_normal`` cuts
it. Every parameter is scaled as ``xavier_normal`` scales it, save a
BatchNorm's: its gain and shift as a LayerNorm's (about 1, and small), its
running mean small and its running variance positive,
``exp(0.25 * draw)`` (0.6 to 1.6 for draws within two standard
deviations), so that the normalisation neither divides by a negative nor
blows its input up. The count of batches a BatchNorm saw is 0.
"""

import math

import torch

from portbench.weights import xavier_normal


def _entry(name: str, draw):
    if name.endswith("bn.running_var"):
        return torch.exp(0.25 * draw)
    if name.endswith("bn.weight"):
        return draw.mul(0.1).add_(1.0)
    if name.endswith(("bn.bias", "bn.running_mean")):
        return draw.mul(0.1)
    mean, sd = xavier_normal._scale(name, draw.shape)
    return draw.mul(sd).add_(mean)


def make(shapes: dict, seed: int, device, model: dict = None) -> dict:
    """Entry name -> tensor on ``device``, from ``seed``: f32, and int64
    for the counts of batches."""
    gen = torch.Generator(device=device).manual_seed(seed)
    floats = {k: s for k, s in shapes.items()
              if not k.endswith("num_batches_tracked")}
    total = sum(math.prod(s) for s in floats.values())
    flat = torch.randn(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        if name not in floats:
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        n = math.prod(shape)
        out[name] = _entry(name, flat[at:at + n].view(shape))
        at += n
    return out
