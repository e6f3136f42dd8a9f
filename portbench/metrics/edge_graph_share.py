"""The share of the measured window's AR batches whose front edge (the
encoders, the decoder's inputs and the decode state) ran as the replay of
its CUDA graph (``translator.graph_edge_passes`` over
``translator.edge_passes``). A program without the counters gives nothing
to read."""


def read(ctx):
    passes = ctx.counts.get("translator.edge_passes", 0)
    if not passes or "translator.graph_edge_passes" not in ctx.counts:
        return None
    return 100.0 * ctx.counts["translator.graph_edge_passes"] / passes
