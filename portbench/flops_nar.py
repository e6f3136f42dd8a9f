"""Operations a NAR decode with an AR teacher needs for one batch, and
K2's at the refinement passes' shape, by ``flops.py``'s counting rules
and peaks.

The model's operations, not the program's: the student's and the
teacher's encodings (each stream's projection and highway block, the
concept detector and the concept vector, and the student's length
predictor), each model's cross-attention keys and values once for the
batch's videos, and each pass's decoder layers and vocab head over every
word of its candidates: the student sees all of a candidate's words, the
teacher the words before each (half the keys, on average).
"""

from portbench import flops
from portbench.flops import _layer_step, _linear


def encoding_flops(m: dict, videos: int, length: bool) -> float:
    """One model's encoding of ``videos`` videos; with ``length`` the
    length predictor."""
    H = m["dim_hidden"]
    f = flops.encoder_flops(m, videos)
    f += sum(2 * _linear(videos * m["rows"][c], H, H) for c in m["modality"])
    if length:
        f += _linear(videos, H, H) + _linear(videos, H, m["max_len"])
    return f + m["num_hidden_layers_decoder"] * 2 * _linear(
        videos * m["cross_attention_keys"], H, H)


def pass_flops(m: dict, candidates: int, causal: bool) -> float:
    """One decoder pass over ``candidates`` rows of ``max_len`` words: its
    layers and its vocab head."""
    L, H, V = m["max_len"], m["dim_hidden"], m["vocab_size"]
    words = candidates * L
    keys = (L + 1) / 2 if causal else L
    return (m["num_hidden_layers_decoder"]
            * _layer_step(m, words, keys, m["cross_attention_keys"])
            + _linear(words, H, V))


def decode_flops(m: dict, batches: int, videos: int, student_rows: int,
                 teacher_rows: int) -> float:
    """``batches`` batches of ``videos``: both encodings of each, and
    passes over ``student_rows`` and ``teacher_rows`` candidates in
    all."""
    return (batches * (encoding_flops(m, videos, True)
                       + encoding_flops(m, videos, False))
            + pass_flops(m, student_rows, False)
            + pass_flops(m, teacher_rows, True))


def k2_bound_seconds(m: dict, shapes: dict) -> float:
    """K2's least time at a pass's shape: every word of the batch's
    candidates against the vocab head."""
    rows = shapes["batch"] * shapes["length_beam"] * shapes["max_len"]
    return flops.bound_seconds(*flops.k2_argmax_lse(
        rows, m["dim_hidden"], m["vocab_size"]))[0]
