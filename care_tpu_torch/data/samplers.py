"""Frame-id samplers (pure functions over an explicit RandomState).

Port of ``care_tpu/data/samplers.py``: every draw goes through the
``np.random.RandomState`` passed in, so both packages draw the same frame
ids from the same seed.

Parity targets: reference ``misc/utils.py:307-338`` and
``dataloader.py:23-31``. Deterministic given the RandomState, so runs are
reproducible per (seed, epoch) like the reference's seeded workers.
"""

from typing import List, Optional

import numpy as np


def resampling(source_length: int, target_length: int) -> List[int]:
    """Round-spaced index resampling (reference ``misc/utils.py:307-308``).

    NB: python's ``round`` uses banker's rounding; we reproduce it.
    """
    return [round(i * (source_length - 1) / (target_length - 1))
            for i in range(target_length)]


def get_uniform_ids_from_k_snippets(length: int, k: int, offset: int = 0):
    bound = [int(i) for i in np.linspace(0, length, k + 1)]
    return [(bound[i] + bound[i + 1]) // 2 + offset for i in range(k)]


def get_random_ids_from_k_snippets(length: int, k: int,
                                   rng: Optional[np.random.RandomState] = None,
                                   offset: int = 0):
    rng = rng or np.random
    bound = [int(i) for i in np.linspace(0, length, k + 1)]
    return [int(rng.randint(bound[i], bound[i + 1])) + offset
            for i in range(k)]


def get_random_ids_from_the_whole(length: int, k: int,
                                  rng: Optional[np.random.RandomState] = None,
                                  offset: int = 0):
    rng = rng or np.random
    ids = rng.choice(length, size=k, replace=False)
    return sorted(int(i) + offset for i in ids)


def get_uniform_items_from_k_snippets(items, k: int):
    return [items[i] for i in get_uniform_ids_from_k_snippets(len(items), k)]


def get_frame_ids(n_total_frames: int, n_frames: int, random_type: str,
                  rng: Optional[np.random.RandomState] = None) -> List[int]:
    """reference ``dataloader.py:23-31``."""
    if random_type == "all_random":
        return get_random_ids_from_the_whole(n_total_frames, n_frames, rng)
    if random_type == "segment_random":
        return get_random_ids_from_k_snippets(n_total_frames, n_frames, rng)
    if random_type == "equally_sampling":
        return get_uniform_ids_from_k_snippets(n_total_frames, n_frames)
    raise ValueError(f"unsupported random_type `{random_type}`")
