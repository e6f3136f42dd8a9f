"""Device idle time a batch (a video in the latency cell) whose gaps ended
at a launch at the batch's edges (``care.encode``, ``care.beam.init``,
``care.beam.final``, ``care.collect`` and the rest of ``care.dispatch``;
``portbench/spans.py``), over the traced window's batches."""

from portbench import spans


def read(ctx):
    s = spans.idle_per(ctx, "batch_edges", "batches")
    return None if s is None else 1e3 * s
