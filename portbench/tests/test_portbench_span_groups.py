"""The span reduction by a table of groups (``spans.reduce(trace,
groups)``): on a synthetic trace whose spans of two tables nest among each
other, the default table gives the numbers worked out by hand, a table of
another kind's spans partitions the same idle time among its own groups,
and the two reductions coexist on the trace."""

import types

import pytest

from portbench import spans
from portbench.devtrace import WINDOW, TraceSummary
from test_portbench_spans import Event

# the default table's spans (``care.*``) and another table's (``nar.*``),
# nested among each other; times in microseconds
HOST = [(WINDOW, 0, 1000),
        ("care.dispatch", 10, 600),
        ("care.encode", 20, 100),
        ("nar.pass", 110, 300),
        ("care.decoder.step", 150, 250),
        ("nar.teacher", 320, 450),
        ("care.beam.step", 330, 400),
        ("care.collect", 700, 800),
        ("care.collect.fetch", 710, 780)]
# (device start, end, host launch or None), and the gap each one ends: its
# length, then its group in the default table and in NAR
DEVICE = [(0, 50, 5),            # at the window's start: no gap
          (80, 90, 30),          # 30: care.encode; care.dispatch
          (200, 230, 160),       # 110: care.decoder.step; nar.pass
          (280, 290, 270),       # 50: care.dispatch; nar.pass
          (360, 380, 340),       # 70: care.beam.step; nar.teacher
          (500, 510, None),      # 120, no launch paired: care.dispatch
          (650, 700, 620),       # 140 outside every span
          (720, 730, 715)]       # 20: care.collect.fetch; care.collect
# and the tail, 730 to 1000, outside
NAR = {"care.dispatch": "batch", "care.collect": "batch",
       "nar.pass": "refine", "nar.teacher": "teacher"}
IDLE_US = {"bookkeeping": 0, "decoder": 180, "batch_edges": 220,
           "outside": 410}
NAR_IDLE_US = {"batch": 170, "refine": 160, "teacher": 70, "outside": 410}
HOST_US = {"care.dispatch": 590, "care.encode": 80, "care.decoder.step": 100,
           "care.beam.step": 70, "care.collect": 100,
           "care.collect.fetch": 70}
NAR_HOST_US = {"care.dispatch": 590, "care.collect": 100, "nar.pass": 190,
               "nar.teacher": 130}


def _trace():
    events = [Event(n, s, t) for n, s, t in HOST]
    for corr, (s, t, launch) in enumerate(DEVICE, start=1):
        events.append(Event("kernel_%d" % corr, s, t, corr, device=True,
                            act="kernel"))
        if launch is not None:
            events.append(Event("cudaLaunchKernel", launch, launch + 2,
                                corr, act="cuda_runtime"))
    return TraceSummary(events)


def _us(d):
    return {k: round(v * 1e6, 6) for k, v in d.items()}


def test_default_table_reads_as_worked_out():
    t = _trace()
    red = spans.reduce(t)
    assert _us(red.idle_s) == IDLE_US
    assert _us(red.host_s) == HOST_US
    assert red.count == dict.fromkeys(HOST_US, 1)
    assert spans.reduce(t, spans.GROUPS) is red
    idle_us = 1e6 * (t.window_s - t.busy_s())
    assert sum(red.idle_s.values()) * 1e6 == pytest.approx(idle_us)


def test_a_table_of_its_own_partitions_the_same_idle():
    t = _trace()
    red = spans.reduce(t, NAR)
    assert _us(red.idle_s) == NAR_IDLE_US
    assert _us(red.host_s) == NAR_HOST_US
    assert sum(NAR_IDLE_US.values()) == sum(IDLE_US.values())
    assert spans.reduce(t, dict(NAR)) is red      # kept by the table


def test_both_reductions_coexist_on_one_trace():
    t = _trace()
    first = spans.reduce(t)
    nar = spans.reduce(t, NAR)
    assert spans.reduce(t) is first and _us(first.idle_s) == IDLE_US
    assert spans.reduce(t, NAR) is nar and _us(nar.idle_s) == NAR_IDLE_US
    ctx = types.SimpleNamespace(trace=t, trace_counts={},
                                trace_samples={"batches": 2})
    assert spans.idle_per(ctx, "refine", "batches", NAR) == \
        pytest.approx(80e-6)
    assert spans.idle_per(ctx, "batch_edges", "batches") == \
        pytest.approx(110e-6)


def test_a_table_whose_spans_are_absent_gives_nothing():
    assert spans.reduce(_trace(), {"other.span": "x"}) is None
