"""Device idle time a batch (a video in the latency cell) whose gaps ended
outside every span of the program (the caller's copies and loop, and the
window's tail; ``portbench/spans.py``), over the traced window's
batches."""

from portbench import spans


def read(ctx):
    s = spans.idle_per(ctx, "outside", "batches")
    return None if s is None else 1e3 * s
