"""The span table of the NAR decode (``care.nar.*``, opened by
``care_tpu_torch/decoding/translator.py`` and ``decoding/nar.py``), for
``spans.reduce(trace, GROUPS)``: each idle gap of the device goes to the
innermost of these spans around the launch that ended it, and the groups
partition the window's idle time:

* ``passes``: ``care.nar.pass`` (a student decoder forward and its
  argmax/lse kernel) and ``care.nar.teacher`` (the teacher's encoding and
  its rescoring pass);
* ``select``: ``care.nar.select``, the bookkeeping between passes (PAD
  semantics, the template's canvas, the choice of the masked positions,
  the merge);
* ``batch_edges``: ``care.nar.encode``, ``care.nar.final``,
  ``care.collect`` (and its ``.fetch``) and the rest of
  ``care.dispatch``;
* ``outside``: no span, the caller's copies and loop.
"""

from portbench import spans

GROUPS = {
    "care.nar.pass": "passes",
    "care.nar.teacher": "passes",
    "care.nar.select": "select",
    "care.nar.encode": "batch_edges",
    "care.nar.final": "batch_edges",
    "care.collect": "batch_edges",
    "care.collect.fetch": "batch_edges",
    "care.dispatch": "batch_edges",
}


def idle_per_pass(ctx, group: str):
    """A group's idle seconds over the traced window's student and teacher
    passes; None where there is nothing to read."""
    red = spans.reduce(ctx.trace, GROUPS)
    if red is None or not ctx.trace.ops or "care.nar.pass" not in red.count:
        return None
    n = (ctx.trace_counts.get("translator.decoder_passes", 0)
         + ctx.trace_counts.get("translator.teacher_passes", 0))
    return red.idle_s[group] / n if n else None


def idle_per_batch(ctx, group: str):
    """A group's idle seconds over the traced window's batches; None where
    the program has no NAR spans."""
    red = spans.reduce(ctx.trace, GROUPS)
    if red is None or "care.nar.pass" not in red.count:
        return None
    return spans.idle_per(ctx, group, "batches", GROUPS)
