"""Operations and bytes the benchmark's kernels and model steps need at
their call's shapes, and the card's peaks.

Each input byte counts as read once and each output byte as written once,
whatever a kernel reads again; operations are those the function needs
(a multiply-add is two). Both configurations compute in float32, which the
port's kernels take on the tensor cores as 3xTF32 (three TF32 products for
one f32 one), so the f32 peak is a third of the TF32 rate. The peaks are
NVIDIA's H100 SXM data sheet's, dense, at the 700 W power limit; a run
prints the card's own limit beside its shares.
"""

PEAK_TF32_FLOPS = 495e12
PEAK_F32_FLOPS = PEAK_TF32_FLOPS / 3
PEAK_BYTES_PER_S = 3.35e12
F32, I64 = 4, 8


def bound_seconds(flops: float, nbytes: float) -> tuple:
    """(the least time the card could take, what bounds it)."""
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def k1_head_topk(rows: int, H: int, V: int, beam: int) -> tuple:
    """K1, ``fused_head_beam_topk``: h [rows, H] x W [V, H] -> the beam's
    top-``beam`` scores and ids over [rows / beam, beam * V], reading the
    beams' scores and EOS flags."""
    n = rows // beam
    flops = 2 * rows * H * V
    nbytes = (F32 * (rows * H + V * H + n * beam) + n * beam
              + (F32 + I64) * n * beam)
    return flops, nbytes


def k2_argmax_lse(rows: int, H: int, V: int) -> tuple:
    """K2, the fused cross-entropy's forward statistics: per row the
    log-sum-exp, the label's logit, the logits' sum and the argmax."""
    flops = 2 * rows * H * V
    nbytes = F32 * (rows * H + V * H) + I64 * rows + (3 * F32 + I64) * rows
    return flops, nbytes


def k3a_dh(rows: int, H: int, V: int) -> tuple:
    """K3a, the gradient of the hidden states: the logits again and their
    softmax's product with W."""
    flops = 4 * rows * H * V
    nbytes = F32 * (2 * rows * H + V * H + 2 * rows) + I64 * rows
    return flops, nbytes


def k3b_dw(rows: int, H: int, V: int) -> tuple:
    """K3b, the gradient of the head's weight."""
    flops = 4 * rows * H * V
    nbytes = F32 * (rows * H + 2 * V * H + 2 * rows) + I64 * rows
    return flops, nbytes


def k4a_decode(batch: int, heads: int, q_rows: int, keys: int,
               head_dim: int) -> tuple:
    """K4a at the decode shape: q [batch, heads, q_rows, head_dim] against
    k, v [batch, heads, keys, head_dim] with a [1, heads, 1, keys] bias."""
    flops = 4 * batch * heads * q_rows * keys * head_dim
    nbytes = F32 * (2 * batch * heads * q_rows * head_dim
                    + 2 * batch * heads * keys * head_dim + heads * keys)
    return flops, nbytes


def _linear(rows, d_in, d_out):
    return 2 * rows * d_in * d_out


def encoder_flops(m: dict, videos: int) -> float:
    """The streams' projections, the concept detector and the concept
    vector, for ``videos`` videos."""
    H, K = m["dim_hidden"], m["attribute_prediction_k"]
    f = sum(_linear(videos * m["rows"][c], m["dims"][c], H)
            for c in m["modality"])
    f += _linear(videos, H * len(m["modality_for_predictor"]), K)
    return f + _linear(videos, K, H)


def _layer_step(m: dict, rows: int, self_keys: int, cross_keys: int) -> float:
    H, F_ = m["dim_hidden"], m["intermediate_size"]
    f = (_linear(rows, H, 3 * H) + 4 * rows * self_keys * H
         + _linear(rows, H, H))
    f += 2 * _linear(rows, H, H) + 4 * rows * cross_keys * H
    return f + _linear(rows, H, F_) + _linear(rows, F_, H)


def serve_batch_flops(m: dict, videos: int, steps: int) -> float:
    """One beam-search decode of ``videos`` videos over ``steps`` steps:
    the encoding, each layer's cross-attention keys and values once, and
    each step's decoder layers and vocab head at ``videos * beam`` rows."""
    H, V, Lk = m["dim_hidden"], m["vocab_size"], m["cross_attention_keys"]
    layers = m["num_hidden_layers_decoder"]
    rows = videos * m["beam_size"]
    f = encoder_flops(m, videos) + layers * 2 * _linear(videos * Lk, H, H)
    for t in range(1, steps + 1):
        f += layers * _layer_step(m, rows, t, Lk) + _linear(rows, H, V)
    return f
