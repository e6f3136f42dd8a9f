"""The port's decode spans and live-instance counters
(``care_tpu_torch/utils/profiling.py:trace_annotation``,
``decoding/translator.py``, ``decoding/beam_search.py``), on the CPU at
test size:

* under a profiler, ``translate_batches`` over two batches opens the span
  tree of the decode: one ``care.beam.step`` a beam step, each holding one
  of each of its four children, a ``care.beam.live`` read before every
  step (and one more where a batch's loop ends early), one
  ``care.dispatch`` / ``care.collect`` a batch; the fused head and the
  dense path alike;
* without a profiler every span is the one shared null context, and the
  decode is bitwise the one under the profiler;
* ``instance_steps`` / ``live_instance_steps`` against a hand count, with
  instances that end at known steps.
"""

import contextlib

import numpy as np
import pytest
import torch

from care_tpu_torch import constants
from care_tpu_torch.decoding import beam_search, get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.utils.profiling import trace_annotation

from test_torch_support import synthetic_feats
from torch_paper_grid import COMMANDS, tiny_opt

STEP_CHILDREN = ("care.decoder.step", "care.head.topk", "care.beam.reorder",
                 "care.beam.finish")
SPANS = {"care.dispatch", "care.encode", "care.beam.init", "care.beam.live",
         "care.beam.step", "care.beam.final", "care.collect",
         "care.collect.fetch", *STEP_CHILDREN}
BATCH, N_BATCHES = 3, 2


@pytest.fixture(scope="module")
def flagship():
    overrides = {c[0]: c[2] for c in COMMANDS}["MSRVTT-CARE-ViT-VA-VAT"]
    opt = tiny_opt(overrides)
    model = build_captioner(opt, device="cpu", seed=5)
    batches = [{"feats": synthetic_feats(opt, BATCH, seed=30 + i)}
               for i in range(N_BATCHES)]
    return opt, model, batches


def _decode(opt, model, batches):
    translator = get_translator(opt, device="cpu")
    out = [r for _, r in translator.translate_batches(model, batches)]
    return translator, out


def _spans(prof):
    """The ``care.*`` host ranges as (name, start, end), by start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("care.")
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer, name):
    return [s for s in spans if s[0] == name
            and outer[1] <= s[1] and s[2] <= outer[2]]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "dense"])
def test_span_tree_of_the_decode(flagship, fused):
    opt, model, batches = flagship
    opt = dict(opt, fused_head_topk=fused)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        translator, traced = _decode(opt, model, batches)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    steps = translator.beam_steps
    assert steps > 0 and set(names) == SPANS
    assert names.count("care.beam.step") == steps
    assert steps <= names.count("care.beam.live") <= steps + N_BATCHES
    for name in ("care.dispatch", "care.collect", "care.encode",
                 "care.beam.final", "care.collect.fetch"):
        assert names.count(name) == N_BATCHES, name
    for step in (s for s in spans if s[0] == "care.beam.step"):
        for child in STEP_CHILDREN:
            assert len(_inside(spans, step, child)) == 1, child
        assert not _inside(spans, step, "care.beam.live")
    dispatches = [s for s in spans if s[0] == "care.dispatch"]
    for name in ("care.encode", "care.beam.init", "care.beam.live",
                 "care.beam.step", "care.beam.final"):
        assert sum(len(_inside(spans, d, name)) for d in dispatches) \
            == names.count(name), name
    for c in (s for s in spans if s[0] == "care.collect"):
        assert len(_inside(spans, c, "care.collect.fetch")) == 1
    # every batch decodes all its instances in each of its steps
    assert translator.instance_steps == BATCH * steps

    # (b) no profiler: the shared null context, and the same decode
    assert trace_annotation("care.beam.step") is trace_annotation("other")
    assert isinstance(trace_annotation("care.dispatch"),
                      contextlib.nullcontext)
    untraced_translator, untraced = _decode(opt, model, batches)
    assert untraced == traced
    assert untraced_translator.beam_steps == steps


def _ending_at(ends, V=8):
    """A step function whose instance ``i`` (beam 1) emits EOS at beam
    step ``ends[i]`` (None: never) and token ``VIS`` at every other."""
    table = np.full((len(ends), 16, V), -5.0, np.float32)
    table[:, :, constants.VIS] = 0.0
    for i, end in enumerate(ends):
        if end is not None:
            table[i, end - 1] = -5.0
            table[i, end - 1, constants.EOS] = 0.0
    table = torch.as_tensor(table)
    return lambda tok, pos, inst: (table[inst, pos], inst)


@pytest.mark.parametrize("ends,max_len,steps,live", [
    # the last instance never ends: every step runs; 3+3+2+2+1+1 live
    ((2, 4, None), 7, 6, 12),
    # both end by step 3: the fourth read ends the loop; 2+2+1 live
    ((2, 3), 7, 3, 5),
])
def test_live_instance_counts(flagship, ends, max_len, steps, live):
    N = len(ends)
    translator = get_translator(flagship[0], device="cpu")
    calls = []
    step_fn = _ending_at(ends)

    def counting_step(tok, pos, inst):
        calls.append(pos)
        return step_fn(tok, pos, inst)

    beam_search(counting_step, torch.arange(N), batch_size=N, vocab_size=8,
                gather_carry=lambda inst, idx: inst[idx], device="cpu",
                beam_size=1, max_len=max_len,
                count_live=translator._count_live)
    assert len(calls) == steps
    assert translator.instance_steps == N * steps
    assert translator.live_instance_steps == live
