"""Device time a batch of the operations launched inside
``care.pointer.kv``, the key and value projection of the retrieved
captions (``portbench/spans_ptr.py``), over the traced window's batches.
A program without the copy head's spans gives nothing to read."""

from portbench import spans_ptr


def read(ctx):
    return spans_ptr.ms_per_batch(ctx, (spans_ptr.KV,))
