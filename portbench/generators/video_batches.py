"""Batches of video features (``"generator": "video_batches"``): the
mix's ``pool_batches`` distinct batches of ``batch`` videos, as many as fit
in ``pool_bytes`` of host memory (at least one), each a list of streams in
the configuration's modality order, and the order they are issued in: the
whole pool in a fresh random order each pass. Floating inputs are drawn on
the device by one ``torch.Generator`` in one call a stream and copied to
the host once, so that the program receives host arrays as its users'
loaders give them.
"""

import numpy as np
import torch


def _randn_host(gen, shape, device) -> np.ndarray:
    return torch.randn(shape, generator=gen, device=device).cpu().numpy()


def video_streams(m: dict, n_videos: int, seed: int, device,
                  rows: dict = None) -> list:
    """One [n_videos, rows, dim] f32 array a feature stream, in the
    configuration's modality order: standard normal features, which is
    what the encoders' LayerNorms see of real ones."""
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = rows or m["rows"]
    return [_randn_host(gen, (n_videos, rows[c], m["dims"][c]), device)
            for c in m["modality"]]


def batch_bytes(m: dict, batch: int) -> int:
    return 4 * batch * sum(m["rows"][c] * m["dims"][c] for c in m["modality"])


def make(m: dict, mix: dict, seed: int, device) -> list:
    """The pool: each batch a list of streams, views of one array a
    stream."""
    size = mix["batch"]
    n = max(1, min(mix.get("pool_batches", 1),
                   mix.get("pool_bytes", 1 << 62) // batch_bytes(m, size)))
    streams = video_streams(m, n * size, seed, device)
    return [[s[b * size:(b + 1) * size] for s in streams] for b in range(n)]


def order(n: int, rng: np.random.Generator):
    """Indices 0..n-1 in a fresh random order each pass, without end."""
    while True:
        yield from rng.permutation(n).tolist()
