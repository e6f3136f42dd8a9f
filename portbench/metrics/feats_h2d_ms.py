"""Device time of the window's host-to-device copies (the profiler's
``Memcpy HtoD``), per batch."""


def read(ctx):
    if ctx.trace is None or not ctx.trace_samples["batches"]:
        return None
    s = ctx.trace.copy_seconds("HtoD")
    return 1e3 * s / ctx.trace_samples["batches"] if s > 0 else None
