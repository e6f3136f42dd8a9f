"""The end-to-end statistics on synthetic samples with a stall: a rate
is over the whole window, a tail over every sample."""

import types

import pytest

from portbench import stats


def _read(name, **ctx):
    import run_readers
    return run_readers.read(name, types.SimpleNamespace(**ctx))


def test_rate_counts_the_stall():
    # 100 captions in 1 s, then a 1 s stall with nothing collected
    assert _read("caps_per_s", samples={"captions": 100},
                 window_s=2.0) == pytest.approx(50.0)


def test_p95_sees_the_stall():
    lat = [0.010] * 90 + [0.500] * 10
    assert _read("video_ms_p95", samples={"latencies_s": lat}) \
        == pytest.approx(500.0)
    # without the stall the tail is the steady latency
    assert _read("video_ms_p95", samples={"latencies_s": [0.010] * 100}) \
        == pytest.approx(10.0)


def test_p95_interpolates_over_every_sample():
    lat = [float(i) for i in range(1, 101)]
    assert stats.p95(lat) == pytest.approx(95.05)
    assert stats.p95([3.0]) == 3.0

