"""Device idle time a pass (student and teacher passes) whose gaps ended
at a launch inside a pass (``care.nar.pass``, ``care.nar.teacher``;
``portbench/spans_nar.py``)."""

from portbench import spans_nar


def read(ctx):
    s = spans_nar.idle_per_pass(ctx, "passes")
    return None if s is None else 1e6 * s
