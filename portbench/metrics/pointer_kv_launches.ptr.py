"""Key and value projections of the retrieved captions a batch
(``models.pointer.kv_launches`` over the measured window's batches): one a
beam step while the copy head projects them in the loop, one a batch once
it does so before. A program without the counter gives nothing to
read."""

LAUNCHES = "models.pointer.kv_launches"


def read(ctx):
    batches = ctx.samples["batches"]
    if not batches or LAUNCHES not in ctx.counts:
        return None
    return ctx.counts[LAUNCHES] / batches
