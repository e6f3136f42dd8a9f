"""The whole PointerGen decode's share of the card's f32 peak: the model's
operations for every batch of the window (``flops_ptr.serve_batch_flops``:
the float streams' encoding, the cross keys and values, each beam step's
decoder, vocab head and copy head, the retrieved captions' keys and
values once a batch) over the window and the peak."""

from portbench import flops, flops_ptr


def read(ctx):
    batches = ctx.samples["batches"]
    steps = ctx.counts.get("translator.beam_steps", 0)
    if not batches or not steps:
        return None
    per_batch = flops_ptr.serve_batch_flops(ctx.model, ctx.shapes["batch"],
                                            round(steps / batches))
    return (100.0 * batches * per_batch
            / (ctx.window_s * flops.PEAK_F32_FLOPS))
