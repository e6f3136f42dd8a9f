"""Kernels the device ran in the traced window, per beam step the
translator counted (``Translator.beam_steps``)."""


def read(ctx):
    if ctx.trace is None:
        return None
    steps = ctx.trace_counts.get("translator.beam_steps", 0)
    if not steps or not ctx.trace.kernel_count():
        return None
    return ctx.trace.kernel_count() / steps
