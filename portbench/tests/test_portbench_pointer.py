"""The PointerGen cell's own pieces on the CPU (``pointergen.serve.b64``):

* the retrieved captions' generator: shapes and dtype, 5-20 words a
  caption (9.3 on average) and a PAD tail, no BOS or EOS, ids that repeat
  within a video, the same pool from the same seed, the float streams as
  ``video_batches`` draws them;
* ``flops_ptr``'s count against a hand count at test size, and the copy
  head's share of a batch at the cell's size;
* the pointer span table (``spans_ptr.GROUPS``) partitions a synthetic
  trace's idle time as worked out by hand, and the copy head's readers
  read its device time, idle and counter from it; a program without the
  copy head's spans and counter gives them nothing to read.
"""

import types

import numpy as np
import pytest
import torch

import tiny
from portbench import flops, flops_ptr, lookup, spans, spans_ptr
from portbench.devtrace import WINDOW, TraceSummary
from portbench.generators import retrieved_captions, video_batches
from portbench.reference import pointer
from test_portbench_spans import Event

CONFIG = "msrvtt-pointergen-care-vit"
MIX = "serve.b64.ret"
BOS, EOS, PAD = 2, 3, 0


def _full():
    return tiny._json("configs", CONFIG + ".json")["model"], \
        tiny._json("traffic", MIX + ".json")


def test_generator_draws_captions_as_msrvtt_has_them():
    m, mix = _full()
    ids = retrieved_captions.retrieved_ids(m, mix, 64, 2**31 + 7)
    assert ids.shape == (64, 20, 30) and ids.dtype == np.int64
    words = (ids != PAD).sum(-1)
    assert words.min() >= 5 and words.max() <= 20
    assert 9.0 <= words.mean() <= 9.6
    # the words first, then a PAD tail
    tail = np.arange(30)[None, None, :] >= words[:, :, None]
    assert ((ids == PAD) == tail).all()
    assert not np.isin(ids, (BOS, EOS)).any()
    assert ids[ids != PAD].min() >= 6 and ids.max() < m["vocab_size"]
    # ids repeat within each video's captions
    for v in ids:
        w = v[v != PAD]
        assert len(np.unique(w)) < len(w)
    again = retrieved_captions.retrieved_ids(m, mix, 64, 2**31 + 7)
    assert np.array_equal(ids, again)
    other = retrieved_captions.retrieved_ids(m, mix, 64, 2**31 + 8)
    assert not np.array_equal(ids, other)


def test_generator_pool_at_test_size():
    cfg, mx = tiny.config(CONFIG), tiny.mix(MIX)
    m = cfg["model"]
    pool = retrieved_captions.make(m, mx, 5, "cpu")
    again = retrieved_captions.make(m, mx, 5, "cpu")
    assert len(pool) == mx["pool_batches"]
    floats = video_batches.video_streams(pointer.float_model(m),
                                         len(pool) * mx["batch"], 5, "cpu")
    for b, (batch, same) in enumerate(zip(pool, again)):
        assert len(batch) == len(m["modality"]) == 5
        t = batch[m["modality"].index("t")]
        assert t.shape == (mx["batch"], 3, 8) and t.dtype == np.int64
        # at max_len 8 a caption keeps a PAD at its end
        words = (t != PAD).sum(-1)
        assert words.min() >= 5 and words.max() <= 7
        rows = slice(b * mx["batch"], (b + 1) * mx["batch"])
        for x, want in zip([x for c, x in zip(m["modality"], batch)
                            if c != "t"], floats):
            assert np.array_equal(x, want[rows])
        assert all(np.array_equal(x, y) for x, y in zip(batch, same))


def test_flops_against_a_hand_count():
    m = tiny.config(CONFIG)["model"]
    H, R, S, rows = 32, 3, 8, 2 * 5
    assert (m["dim_hidden"], m["retrieval_topk"], m["max_len"]) == (H, R, S)
    # the captions' keys and values once; each step's query, scores and
    # context over R * S tokens a row
    once = 2 * 2 * (2 * R * S) * H * H
    step = 2 * rows * H * H + 4 * rows * R * S * H
    assert flops_ptr.copy_head_flops(m, 2, 3) == once + 3 * step == 350208
    assert (flops_ptr.serve_batch_flops(m, 2, 3)
            - flops.serve_batch_flops(pointer.float_model(m), 2, 3)
            == 350208)
    full, _ = _full()
    # a batch of 64 at 29 steps: 56.5 of 245.0 GFLOP in the copy head
    assert round(flops_ptr.copy_head_flops(full, 64, 29) / 1e9, 2) == 56.53
    assert round(flops_ptr.serve_batch_flops(full, 64, 29) / 1e9, 2) == 245.05


# times in microseconds: one batch of one beam step whose decoder step
# holds the copy head, and the key and value projection inside that
HOST = [(WINDOW, 0, 1000),
        ("care.dispatch", 10, 700),
        ("care.encode", 20, 80),
        ("care.beam.init", 80, 100),
        ("care.beam.live", 100, 110),
        ("care.beam.step", 110, 400),
        ("care.decoder.step", 120, 330),
        ("care.pointer", 200, 320),
        ("care.pointer.kv", 210, 250),
        ("care.head.topk", 330, 360),
        ("care.beam.finish", 360, 380),
        ("care.beam.reorder", 380, 395),
        ("care.beam.final", 600, 650),
        ("care.collect", 750, 850)]
# (device start, end, host launch): the gap each ends, and where
DEVICE = [(0, 30, 5),            # no gap; launched outside every span
          (60, 70, 50),          # 30: care.encode
          (150, 190, 125),       # 80: care.decoder.step
          (220, 300, 215),       # 30: care.pointer.kv (80 of device)
          (300, 340, 245),       # no gap: care.pointer.kv (40)
          (350, 380, 260),       # 10: care.pointer (30)
          (380, 390, 318),       # no gap: care.pointer (10)
          (400, 410, 340),       # 10: care.head.topk
          (420, 430, 385),       # 10: care.beam.reorder
          (640, 660, 610),       # 210: care.beam.final
          (800, 810, 760)]       # 140: care.collect; the tail 190 outside
IDLE_US = {"pointer": 40, "decoder": 90, "bookkeeping": 10,
           "batch_edges": 380, "outside": 190}


def _trace(host=HOST):
    events = [Event(n, s, t) for n, s, t in host]
    for corr, (s, t, launch) in enumerate(DEVICE, start=1):
        events.append(Event("kernel_%d" % corr, s, t, corr, device=True,
                            act="kernel"))
        events.append(Event("cudaLaunchKernel", launch, launch + 2, corr,
                            act="cuda_runtime"))
    return TraceSummary(events)


def _ctx(trace):
    return types.SimpleNamespace(
        trace=trace, trace_samples={"batches": 1},
        trace_counts={"translator.beam_steps": 1},
        samples={"batches": 2},
        counts={"models.pointer.kv_launches": 58,
                "translator.beam_steps": 58})


def test_pointer_table_partitions_the_idle():
    t = _trace()
    red = spans.reduce(t, spans_ptr.GROUPS)
    assert {k: round(v * 1e6, 6) for k, v in red.idle_s.items()} == IDLE_US
    idle_us = 1e6 * (t.window_s - t.busy_s())
    assert sum(red.idle_s.values()) * 1e6 == pytest.approx(idle_us) == 710
    # the AR table puts the copy head's gaps in the decoder's group
    ar = spans.reduce(t)
    assert ar.idle_s["decoder"] == pytest.approx(
        red.idle_s["decoder"] + red.idle_s["pointer"])
    assert {k: ar.idle_s[k] for k in ("bookkeeping", "batch_edges",
                                      "outside")} == pytest.approx(
        {k: red.idle_s[k] for k in ("bookkeeping", "batch_edges",
                                    "outside")})


def test_pointer_readers():
    ctx = _ctx(_trace())
    read = {name: lookup.reader(name)(ctx) for name in (
        "pointer_ms.ptr", "pointer_kv_ms.ptr", "pointer_idle_us.ptr",
        "pointer_kv_launches.ptr", "decoder_idle_us.ptr")}
    assert read == pytest.approx({
        "pointer_ms.ptr": 0.160, "pointer_kv_ms.ptr": 0.120,
        "pointer_idle_us.ptr": 40, "pointer_kv_launches.ptr": 29,
        # the AR reader keeps the AR table: the copy head's idle in it
        "decoder_idle_us.ptr": 130})
    assert spans_ptr.device_seconds(ctx.trace, (spans_ptr.POINTER,)) == \
        pytest.approx(40e-6)


def test_a_program_without_the_copy_head_spans_gives_nothing():
    bare = _trace([h for h in HOST if not h[0].startswith("care.pointer")])
    ctx = _ctx(bare)
    ctx.counts = {"translator.beam_steps": 58}
    for name in ("pointer_ms.ptr", "pointer_kv_ms.ptr", "pointer_idle_us.ptr",
                 "pointer_kv_launches.ptr"):
        assert lookup.reader(name)(ctx) is None, name
    # the readers the cell shares with the AR cells still read
    assert lookup.reader("batch_edge_idle_ms.ptr")(ctx) == \
        pytest.approx(0.380)
    assert lookup.reader("idle_share.ptr")(ctx) == pytest.approx(71.0)
    ctx.trace = None
    assert lookup.reader("pointer_ms.ptr")(ctx) is None


def test_the_reference_in_tf32_differs():
    cfg = tiny.config(CONFIG)
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(
        pointer.param_shapes(m), 5, "cpu", m)
    g = torch.Generator().manual_seed(9)
    hidden = torch.randn(2, 4, m["dim_hidden"], generator=g)
    ids = torch.as_tensor(retrieved_captions.retrieved_ids(
        m, tiny.mix(MIX), 2, 9))
    embs = pointer.retrieved_embs(P, m, ids)
    f32 = pointer.log_probs(P, m, hidden, embs, ids)
    with pointer.precision("tf32"):
        low = pointer.log_probs(P, m, hidden, embs, ids)
    assert float((f32 - low).abs().max()) > 1e-5
