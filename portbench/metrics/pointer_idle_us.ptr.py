"""Device idle time a beam step whose gaps ended at a launch inside the
copy head (``care.pointer``, ``care.pointer.kv``;
``portbench/spans_ptr.py``), over the traced window's
``translator.beam_steps``. A program without the copy head's spans gives
nothing to read."""

from portbench import spans_ptr


def read(ctx):
    s = spans_ptr.idle_per_step(ctx, "pointer")
    return None if s is None else 1e6 * s
