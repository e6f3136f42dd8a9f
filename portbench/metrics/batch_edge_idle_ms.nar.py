"""Device idle time a batch whose gaps ended at a launch at the batch's
edges (``care.nar.encode``, ``care.nar.final``, ``care.collect`` and the
rest of ``care.dispatch``; ``portbench/spans_nar.py``), over the traced
window's batches."""

from portbench import spans_nar


def read(ctx):
    s = spans_nar.idle_per_batch(ctx, "batch_edges")
    return None if s is None else 1e3 * s
