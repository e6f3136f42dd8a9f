"""The whole NAR decode's share of the card's f32 peak: the model's
operations for every batch of the window (both encodings, each model's
cross-attention keys and values, and every student and teacher pass over
the candidates that ``translator.row_passes`` counts,
``flops_nar.decode_flops``) over the window and the peak. A program
without the counter gives nothing to read."""

from portbench import flops, flops_nar


def read(ctx):
    batches = ctx.samples["batches"]
    rows = ctx.counts.get("translator.row_passes")
    if not batches or not rows:
        return None
    teacher = (ctx.counts.get("translator.teacher_passes", 0)
               * ctx.shapes["batch"] * ctx.shapes["length_beam"])
    work = flops_nar.decode_flops(ctx.model, batches, ctx.shapes["batch"],
                                  rows - teacher, teacher)
    return 100.0 * work / (ctx.window_s * flops.PEAK_F32_FLOPS)
