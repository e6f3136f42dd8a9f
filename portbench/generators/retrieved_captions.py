"""Batches of video features with their retrieved captions (``"generator":
"retrieved_captions"``): the float streams as ``video_batches`` draws
them, and the ``t`` stream, the token ids of the ``retrieval_topk``
training captions retrieved for each video, int64 [videos, R, max_len].

A caption has ``caption_words`` (low, high) words, ``5 + Poisson(mean -
5)`` clipped there (MSRVTT's train captions: 5 to 20 words, 9.3 on
average), then a PAD tail; no BOS and no EOS (``exclude_eos``). Its words
are drawn Zipf (exponent ``zipf``) over the ids 6 .. V-1, the most common
first, so that ids repeat within a video's captions as "a", "man" and
"the" do. The retrieval database is not in the repository: the ids come
from the seed, by ``numpy``'s generator, in one draw for the pool.
"""

import numpy as np

from portbench.generators import video_batches
from portbench.generators.video_batches import order  # noqa: F401
from portbench.reference import pointer

PAD, FIRST_WORD = 0, 6


def caption_lengths(rng, shape, mix: dict, max_len: int) -> np.ndarray:
    """Words a caption, clipped to leave a PAD at the end of each."""
    low, high = mix["caption_words"]
    high = min(high, max_len - 1)
    n = low + rng.poisson(mix["mean_words"] - low, shape)
    return np.clip(n, min(low, high), high)


def retrieved_ids(m: dict, mix: dict, n_videos: int, seed: int) -> np.ndarray:
    """The ``t`` stream of ``n_videos`` videos, int64 [n, R, S]."""
    rng = np.random.default_rng(seed)
    R, S = pointer.retrieval_shape(m)
    words = m["vocab_size"] - FIRST_WORD
    p = 1.0 / np.arange(1, words + 1) ** mix["zipf"]
    ids = FIRST_WORD + np.searchsorted(np.cumsum(p / p.sum()),
                                       rng.random((n_videos, R, S)))
    ids = np.minimum(ids, m["vocab_size"] - 1)
    lengths = caption_lengths(rng, (n_videos, R), mix, S)
    tail = np.arange(S)[None, None, :] >= lengths[:, :, None]
    return np.where(tail, PAD, ids).astype(np.int64)


def batch_bytes(m: dict, batch: int) -> int:
    R, S = pointer.retrieval_shape(m)
    return (video_batches.batch_bytes(pointer.float_model(m), batch)
            + 8 * batch * R * S)


def make(m: dict, mix: dict, seed: int, device) -> list:
    """The pool: each batch a list of streams in the configuration's
    modality order, views of one array a stream."""
    size = mix["batch"]
    n = max(1, min(mix.get("pool_batches", 1),
                   mix.get("pool_bytes", 1 << 62) // batch_bytes(m, size)))
    floats = iter(video_batches.video_streams(pointer.float_model(m),
                                              n * size, seed, device))
    ids = retrieved_ids(m, mix, n * size, seed)
    streams = [ids if c == "t" else next(floats) for c in m["modality"]]
    return [[s[b * size:(b + 1) * size] for s in streams] for b in range(n)]
