"""The NACF cell's own pieces on the CPU (``nacf.serve.b64``):

* ``flops_nar``'s K2 bound at the refinement passes' 11 520 rows is the
  kernel table's 0.7864 ms (``PERF.md`` section 6);
* the NAR span table (``spans_nar.GROUPS``) partitions a synthetic
  trace's idle time as worked out by hand, and its readers read it per
  pass and per batch;
* ``tiny.config`` shrinks the teacher's options with the student's;
* the weights maker draws every BatchNorm variance above 0;
* the reference decoding in TF32 differs from the reference in f32, so
  the control can fail.
"""

import types

import pytest
import torch

import tiny
from portbench import flops_nar, lookup, spans, spans_nar
from portbench.devtrace import WINDOW, TraceSummary
from portbench.judges import nacf as judge
from portbench.reference import care, nacf
from test_portbench_spans import Event

CONFIG = "msrvtt-nacf-care-vit"


def test_k2_bound_at_the_pass_shape():
    m = tiny._json("configs", CONFIG + ".json")["model"]
    shapes = {"batch": 64, "length_beam": 6, "max_len": 30}
    assert round(1e3 * flops_nar.k2_bound_seconds(m, shapes), 4) == 0.7864


# times in microseconds: one batch of two passes and a teacher pass
HOST = [(WINDOW, 0, 1000),
        ("care.dispatch", 10, 600),
        ("care.nar.encode", 20, 100),
        ("care.nar.select", 100, 110),
        ("care.nar.pass", 110, 300),
        ("care.nar.select", 300, 320),
        ("care.nar.pass", 320, 420),
        ("care.nar.teacher", 430, 500),
        ("care.nar.final", 500, 520),
        ("care.collect", 700, 800)]
# (device start, end, host launch or None): the gap each ends, and where
DEVICE = [(0, 50, 5),            # no gap
          (80, 90, 30),          # 30: care.nar.encode
          (200, 230, 160),       # 110: care.nar.pass
          (330, 340, 305),       # 100: care.nar.select
          (380, 390, 350),       # 40: care.nar.pass
          (460, 470, 440),       # 70: care.nar.teacher
          (540, 545, 510),       # 70: care.nar.final
          (560, 565, 590),       # 15: care.dispatch
          (650, 700, 620),       # 85: outside
          (720, 730, 715)]       # 20: care.collect; the tail 270 outside
IDLE_US = {"passes": 220, "select": 100, "batch_edges": 135,
           "outside": 355}


def _trace():
    events = [Event(n, s, t) for n, s, t in HOST]
    for corr, (s, t, launch) in enumerate(DEVICE, start=1):
        events.append(Event("kernel_%d" % corr, s, t, corr, device=True,
                            act="kernel"))
        events.append(Event("cudaLaunchKernel", launch, launch + 2, corr,
                            act="cuda_runtime"))
    return TraceSummary(events)


def test_nar_span_table_partitions_the_idle():
    t = _trace()
    red = spans.reduce(t, spans_nar.GROUPS)
    assert {k: round(v * 1e6, 6) for k, v in red.idle_s.items()} == IDLE_US
    idle_us = 1e6 * (t.window_s - t.busy_s())
    assert sum(red.idle_s.values()) * 1e6 == pytest.approx(idle_us)
    assert red.count["care.nar.pass"] == 2
    # two student passes and one teacher pass, one batch
    ctx = types.SimpleNamespace(
        trace=t, trace_samples={"batches": 1},
        trace_counts={"translator.decoder_passes": 2,
                      "translator.teacher_passes": 1})
    read = {name: lookup.reader(name)(ctx) for name in (
        "pass_idle_us.nar", "select_idle_us.nar", "batch_edge_idle_ms.nar",
        "outside_idle_ms.nar")}
    assert read == pytest.approx({
        "pass_idle_us.nar": 220 / 3, "select_idle_us.nar": 100 / 3,
        "batch_edge_idle_ms.nar": 0.135, "outside_idle_ms.nar": 0.355})
    # a program without the NAR spans gives nothing to read
    bare = TraceSummary([Event(WINDOW, 0, 1000)])
    ctx.trace = bare
    assert all(lookup.reader(name)(ctx) is None for name in read)


def test_tiny_config_shrinks_the_teacher_too():
    cfg = tiny.config(CONFIG)
    t = judge.teacher_config(cfg)
    assert t["get_opt"]["method"] == "ARB"
    assert t["get_opt"]["vocab_size"] == tiny.TINY["vocab_size"]
    assert t["set"] == cfg["set"]
    assert not set(cfg["nar_only"]) & set(t["model"])
    from portbench import program
    opt = program.program_opt(t)
    assert opt["decoding_type"] == "ARFormer"
    assert opt["dim_hidden"] == tiny.TINY["dim_hidden"]


def test_batchnorm_variances_drawn_positive():
    cfg = tiny.config(CONFIG)
    m = cfg["model"]
    make = lookup.module("weights", cfg["weights"]).make
    for seed in (1, 2**31 + 17):
        P = make(judge.param_shapes(m), seed, "cpu", m)
        var = [v for k, v in P.items() if k.endswith("running_var")]
        assert len(var) == 2 * len(m["modality"])
        assert all(bool((v > 0).all()) for v in var)
        counts = [v for k, v in P.items() if k.endswith("batches_tracked")]
        assert all(v.dtype == torch.long and int(v) == 0 for v in counts)


def test_tf32_reference_differs():
    cfg = tiny.config(CONFIG)
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(
        judge.param_shapes(m), 5, "cpu", m)
    Ps, Pt = nacf.split(P)
    g = torch.Generator().manual_seed(9)
    feats = {c: torch.randn(1, m["rows"][c], m["dims"][c], generator=g)
             for c in m["modality"]}
    f32 = nacf.mask_predict(Ps, Pt, m, feats)
    with care.precision("tf32"):
        low = nacf.mask_predict(Ps, Pt, m, feats)
    assert f32["lprobs"] != low["lprobs"]
    gap = max(abs(a - b) for a, b in zip(f32["lprobs"], low["lprobs"]))
    assert gap > 1e-6
