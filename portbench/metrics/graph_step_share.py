"""The share of the measured window's beam steps that ran as the replay of
their CUDA graph (``translator.graph_steps`` over
``translator.beam_steps``). A program without the counter gives nothing to
read."""


def read(ctx):
    steps = ctx.counts.get("translator.beam_steps", 0)
    if not steps or "translator.graph_steps" not in ctx.counts:
        return None
    return 100.0 * ctx.counts["translator.graph_steps"] / steps
