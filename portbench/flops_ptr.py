"""Operations PointerGen CARE needs for one batch of a beam-search decode,
by ``flops.py``'s counting rules and peaks.

The model's operations, not the program's: the float streams' encoding,
each decoder layer's cross-attention keys and values once, each step's
decoder layers and vocab head at ``videos * beam`` rows, the copy head's
key and value projections of the retrieved captions once a batch at
``videos * R * S`` rows (the captions are a video's, whatever its beam),
and each step's query projection with its scores and context over a row's
``R * S`` retrieved tokens. The gate and the mixing of the masses are
left out (a few operations an element). A program that projects the
retrieved captions at every step does more work than this counts, so that
taking the projection out of the loop moves the share by time alone.
"""

from portbench import flops
from portbench.flops import _linear
from portbench.reference import pointer


def copy_head_flops(m: dict, videos: int, steps: int) -> float:
    """The copy head's part of one decode."""
    H = m["dim_hidden"]
    R, S = pointer.retrieval_shape(m)
    rows = videos * m["beam_size"]
    once = 2 * _linear(videos * R * S, H, H)
    return once + steps * (_linear(rows, H, H) + 4 * rows * R * S * H)


def serve_batch_flops(m: dict, videos: int, steps: int) -> float:
    """One beam-search decode of ``videos`` videos over ``steps`` steps."""
    return (flops.serve_batch_flops(pointer.float_model(m), videos, steps)
            + copy_head_flops(m, videos, steps))
