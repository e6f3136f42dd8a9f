"""The readers of the program's spans (``portbench/spans.py`` and the
``*_idle_*``, ``step_host_us``, ``sync_wait_us`` and
``live_instance_share`` readers): on a synthetic trace built to a known
answer, each idle gap goes to its innermost span's group and the four
groups sum to the window's idle time; a program without spans gives
nothing to read; a CPU run of a tiny cell reports the host spans and the
counter, and no device idle."""

import time
import types

import pytest
import torch

import tiny
from portbench import run, spans
from portbench.devtrace import WINDOW, TraceSummary
from run_readers import read

US = 1000  # the synthetic trace's times are in microseconds


class Event:
    """What ``TraceSummary`` reads of a profiler event."""

    def __init__(self, name, start, end, corr=0, device=False, act=""):
        self._v = (name, start * US, (end - start) * US, corr, act)
        self._dev = (torch.autograd.DeviceType.CUDA if device
                     else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def correlation_id(self):
        return self._v[3]

    def activity_type(self):
        return self._v[4]

    def device_type(self):
        return self._dev


HOST = [(WINDOW, 0, 1000),
        ("care.dispatch", 10, 600),
        ("care.encode", 20, 100),
        ("care.beam.live", 110, 130),
        ("care.beam.step", 140, 400),
        ("care.decoder.step", 150, 250),
        ("care.head.topk", 260, 300),
        ("care.beam.reorder", 310, 350),
        ("care.beam.finish", 360, 390),
        ("care.beam.live", 410, 420),
        ("care.beam.final", 430, 500),
        ("care.collect", 700, 800),
        ("care.collect.fetch", 710, 780)]
# (device start, end, host launch or None): the gap each one ends, and
# the group it goes to
DEVICE = [(0, 50, 5),            # at the window's start: no gap
          (80, 90, 30),          # 30 in care.encode: batch edges
          (200, 230, 160),       # 110 in care.decoder.step: decoder
          (235, 240, 145),       # 5 in care.beam.step itself: decoder
          (330, 340, 320),       # 90 in care.beam.reorder: bookkeeping
          (345, 350, None),      # 5, no launch paired, starts in reorder
          (415, 416, 412),       # 65 in care.beam.live: bookkeeping
          (450, 460, 405),       # 34 in care.dispatch itself: batch edges
          (455, 470, 440),       # overlaps the one before: no gap
          (650, 700, 620),       # 180 outside every span
          (720, 730, 715)]       # 20 in care.collect.fetch: batch edges
# and the tail, 730 to 1000, outside
IDLE_US = {"bookkeeping": 160, "decoder": 115, "batch_edges": 84,
           "outside": 450}


def _trace(host=HOST):
    events = [Event(n, s, t) for n, s, t in host]
    for corr, (s, t, launch) in enumerate(DEVICE, start=1):
        events.append(Event("kernel_%d" % corr, s, t, corr, device=True,
                            act="kernel"))
        if launch is not None:
            events.append(Event("cudaLaunchKernel", launch, launch + 2,
                                corr, act="cuda_runtime"))
    return TraceSummary(events)


def _ctx(trace, steps=1, batches=2, counts=None):
    return types.SimpleNamespace(
        trace=trace, trace_counts={"translator.beam_steps": steps},
        trace_samples={"batches": batches}, counts=counts or {})


def test_each_gap_goes_to_its_innermost_span():
    red = spans.reduce(_trace())
    assert {g: round(s * 1e6, 6) for g, s in red.idle_s.items()} == IDLE_US
    assert red.count["care.beam.live"] == 2
    assert spans.reduce(_trace()) is not red     # made once per trace
    t = _trace()
    assert spans.reduce(t) is spans.reduce(t)


def test_idle_readers_partition_the_idle_share():
    trace = _trace()
    ctx = _ctx(trace, steps=2, batches=4)
    got = {m: read(m + ".serve", ctx) for m in (
        "bookkeeping_idle_us", "decoder_idle_us", "batch_edge_idle_ms",
        "outside_idle_ms")}
    assert got["bookkeeping_idle_us"] == pytest.approx(160 / 2)
    assert got["decoder_idle_us"] == pytest.approx(115 / 2)
    assert got["batch_edge_idle_ms"] == pytest.approx(84e-3 / 4)
    assert got["outside_idle_ms"] == pytest.approx(450e-3 / 4)
    idle_us = 10 * read("idle_share.serve", ctx)     # % of 1000 us
    parts = (2 * (got["bookkeeping_idle_us"] + got["decoder_idle_us"])
             + 4e3 * (got["batch_edge_idle_ms"] + got["outside_idle_ms"]))
    assert parts == pytest.approx(idle_us, rel=1e-9)


def test_host_span_readers():
    ctx = _ctx(_trace(), steps=1)
    assert read("step_host_us.serve", ctx) == pytest.approx(260)
    assert read("sync_wait_us.latency", ctx) == pytest.approx(30)
    ctx = _ctx(None, counts={"translator.instance_steps": 640,
                             "translator.live_instance_steps": 480})
    assert read("live_instance_share.serve", ctx) == pytest.approx(75)


def test_a_program_without_spans_gives_nothing_to_read():
    ctx = _ctx(_trace(host=HOST[:1]))
    for name in ("bookkeeping_idle_us", "decoder_idle_us",
                 "batch_edge_idle_ms", "outside_idle_ms", "step_host_us",
                 "sync_wait_us", "live_instance_share"):
        assert read(name + ".serve", ctx) is None, name
    assert read("idle_share.serve", ctx) is not None


def test_cpu_run_reports_host_spans_and_the_counter():
    b, c, cfg, mx = tiny.cell("flagship.serve.b64")
    out = run.run_cell(b, c, cfg, mx, 2**31 + 19, 0.5, True, "cpu",
                       t_start=time.perf_counter())
    got = out["metrics"]
    for name in ("step_host_us.serve", "sync_wait_us.serve",
                 "live_instance_share.serve"):
        assert got[name]["value"] > 0, name
    assert 0 < got["live_instance_share.serve"]["value"] <= 100
    for name in ("bookkeeping_idle_us", "decoder_idle_us",
                 "batch_edge_idle_ms", "outside_idle_ms"):
        assert name + ".serve" not in got        # no device operations
    counts = out["counts"]
    assert counts["translator.instance_steps"] == \
        mx["batch"] * counts["translator.beam_steps"]
