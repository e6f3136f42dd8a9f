"""Device idle time a beam step whose gaps ended at a launch inside the
beam's own work (``care.beam.live``, ``.reorder``, ``.finish``;
``portbench/spans.py``), over the traced window's
``translator.beam_steps``."""

from portbench import spans


def read(ctx):
    s = spans.idle_per(ctx, "bookkeeping", "steps")
    return None if s is None else 1e6 * s
