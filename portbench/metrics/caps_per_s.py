"""Captions collected in the window over the whole window (from its start
to the collection of the last caption), on the host clock."""


def read(ctx):
    return ctx.samples["captions"] / ctx.window_s
