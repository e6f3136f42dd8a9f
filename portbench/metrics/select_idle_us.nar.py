"""Device idle time a pass (student and teacher passes) whose gaps ended
at a launch inside the bookkeeping between passes (``care.nar.select``;
``portbench/spans_nar.py``)."""

from portbench import spans_nar


def read(ctx):
    s = spans_nar.idle_per_pass(ctx, "select")
    return None if s is None else 1e6 * s
