"""Device idle time a beam step whose gaps ended at a launch inside the
decoder step and the head (``care.decoder.step``, ``care.head.topk`` and
the rest of ``care.beam.step``; ``portbench/spans.py``), over the traced
window's ``translator.beam_steps``."""

from portbench import spans


def read(ctx):
    s = spans.idle_per(ctx, "decoder", "steps")
    return None if s is None else 1e6 * s
