"""Launches of the beam step's bookkeeping kernel per beam step the
translator counted (``ops.beam_bookkeeping.launches`` over
``translator.beam_steps``), as a share: 100 where every step's reorder and
finished bookkeeping ran as the one kernel, replayed steps included. A
program without the counter gives nothing to read."""


def read(ctx):
    steps = ctx.counts.get("translator.beam_steps", 0)
    if not steps or "ops.beam_bookkeeping.launches" not in ctx.counts:
        return None
    return 100.0 * ctx.counts["ops.beam_bookkeeping.launches"] / steps
