"""Device idle time a batch whose gaps ended outside every span of the
NAR decode's table (the caller's copies and loop, and the window's tail;
``portbench/spans_nar.py``), over the traced window's batches."""

from portbench import spans_nar


def read(ctx):
    s = spans_nar.idle_per_batch(ctx, "outside")
    return None if s is None else 1e3 * s
