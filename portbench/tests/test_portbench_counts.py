"""The operation and byte counts reproduce the bounds of PERF.md's kernel
table at its shapes, and the model's count per caption is the one the
issue of the benchmark states."""

import pytest

from portbench import flops


def ms(work):
    return 1e3 * flops.bound_seconds(*work)[0]


@pytest.mark.parametrize("name,work,want,bound", [
    ("K1", flops.k1_head_topk(320, 512, 11000, 5), 0.0218, "operations"),
    ("K2", flops.k2_argmax_lse(1856, 512, 11000), 0.1267, "operations"),
    ("K3a", flops.k3a_dh(1856, 512, 11000), 0.2534, "operations"),
    ("K3b", flops.k3b_dw(1856, 512, 11000), 0.2534, "operations"),
    ("K2 NAR", flops.k2_argmax_lse(11520, 512, 11000), 0.7864, "operations"),
    ("K4a decode 64", flops.k4a_decode(64, 8, 5, 1654, 64), 0.1298, "bytes"),
    ("K4a decode 17", flops.k4a_decode(17, 8, 5, 1654, 64), 0.0345, "bytes"),
])
def test_kernel_bounds_match_perf_table(name, work, want, bound):
    assert round(ms(work), 4) == want, name
    assert flops.bound_seconds(*work)[1] == bound


def test_peaks():
    assert flops.PEAK_F32_FLOPS == pytest.approx(165e12)
    assert flops.PEAK_BYTES_PER_S == 3.35e12


def _flagship():
    import tiny
    return tiny._json("configs", "msrvtt-care-vit.json")["model"]


def test_serve_flops_per_caption():
    # about 2.9 GFLOP a caption at 29 beam steps of beam 5
    per_caption = flops.serve_batch_flops(_flagship(), 64, 29) / 64
    assert 2.5e9 < per_caption < 3.3e9


def test_serve_flops_grow_with_steps():
    m = _flagship()
    a, b = (flops.serve_batch_flops(m, 64, s) for s in (28, 29))
    step = flops._layer_step(m, 320, 29, m["cross_attention_keys"]) \
        + 2 * 320 * 512 * 11000
    assert b - a == step
