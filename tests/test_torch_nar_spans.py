"""The port's NAR decode spans and its row counter
(``decoding/translator.py:TranslatorNARFormer``, ``decoding/nar.py``), on
the CPU at test size: NACF CARE (mask-predict with the coarse-grained
template, 5 iterations) rescored by an ARB CARE teacher.

* under a profiler, one batch opens ``care.nar.encode`` once, one
  ``care.nar.pass`` a student pass, ``care.nar.teacher`` around the
  teacher's encoding and each rescoring pass, ``care.nar.final`` around
  the candidates' log-probabilities and the length beam's choice, and a
  ``care.nar.select`` around each stretch of bookkeeping between passes;
  no pass lies inside a ``care.nar.select``, and every ``care.nar.*``
  span inside the batch's ``care.dispatch``;
* ``row_passes`` counts the candidates of every student and teacher pass;
* the decode under the profiler is bitwise the one without it.
"""

import pytest
import torch

from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner

from test_torch_support import synthetic_feats
from torch_paper_grid import VERS_MSRVTT, tiny_opt

BATCH = 3
CARE = dict(VERS_MSRVTT, task="CARE")


@pytest.fixture(scope="module")
def models():
    opt = tiny_opt(dict(CARE, method="NACF",
                        with_teacher_during_training=True))
    t_opt = tiny_opt(dict(CARE, method="ARB"))
    student = build_captioner(opt, device="cpu", seed=3)
    teacher = build_captioner(t_opt, device="cpu", seed=7)
    batch = {"feats": synthetic_feats(opt, BATCH, seed=11)}
    return opt, student, teacher, batch


def _decode(opt, student, teacher, batch):
    tr = get_translator(opt, device="cpu")
    return tr, tr.translate_batch(student, batch, teacher=teacher)


def _spans(prof):
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("care.")
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda s: (s[1], -s[2]))


def _inside(spans, outer, name):
    return [s for s in spans if s[0] == name
            and outer[1] <= s[1] and s[2] <= outer[2]]


def test_nar_spans_counter_and_bitwise_decode(models):
    opt, student, teacher, batch = models
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr, traced = _decode(opt, student, teacher, batch)
    spans = _spans(prof)
    names = [s[0] for s in spans]
    passes = tr.decoder_passes
    assert (passes, tr.teacher_passes) == (opt["iterations"] + 1, 1)
    assert names.count("care.nar.pass") == passes
    assert names.count("care.nar.teacher") == 1 + tr.teacher_passes
    assert names.count("care.nar.encode") == 1
    assert names.count("care.nar.final") == 2
    # the canvas masks; per pass its PAD semantics; the template's canvas
    # and probabilities; per refinement the choice, the masked canvas and
    # the merge
    assert names.count("care.nar.select") == 1 + passes + 2 + 3 * (passes
                                                                    - 1)
    for sel in (s for s in spans if s[0] == "care.nar.select"):
        assert not _inside(spans, sel, "care.nar.pass")
        assert not _inside(spans, sel, "care.nar.teacher")
    dispatch, = (s for s in spans if s[0] == "care.dispatch")
    nar = [s for s in spans if s[0].startswith("care.nar.")]
    assert all(dispatch[1] <= s[1] and s[2] <= dispatch[2] for s in nar)

    lbs = opt["length_beam_size"]
    assert tr.row_passes == (passes + tr.teacher_passes) * BATCH * lbs

    _, untraced = _decode(opt, student, teacher, batch)
    assert untraced == traced
