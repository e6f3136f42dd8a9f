"""The host time of the program's ``care.beam.live`` spans (the read of
the loop condition, which waits for the device) in the traced window, over
its ``translator.beam_steps``."""

from portbench import spans


def read(ctx):
    red = spans.reduce(ctx.trace)
    if red is None or "care.beam.live" not in red.host_s:
        return None
    steps = ctx.trace_counts.get("translator.beam_steps", 0)
    return 1e6 * red.host_s["care.beam.live"] / steps if steps else None
