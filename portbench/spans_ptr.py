"""The span table of the pointer decode (PointerGen CARE), for
``spans.reduce(trace, GROUPS)``: the autoregressive table
(``spans.GROUPS``) with the copy head's spans as a group of their own,
``pointer``: ``care.pointer`` (the copy head and the log of its
probabilities inside ``Captioner.decode_step``, itself inside
``care.decoder.step``) and ``care.pointer.kv`` (the key and value
projection of the retrieved captions). Each idle gap goes to the
innermost span around the launch that ended it, so the groups still
partition the window's idle time; the ``decoder`` group keeps the rest of
the step.

``device_seconds`` attributes device time the same way: each device
operation to the innermost of these spans around its host launch.
"""

from portbench import spans

POINTER = "care.pointer"
KV = "care.pointer.kv"
GROUPS = dict(spans.GROUPS, **{POINTER: "pointer", KV: "pointer"})


def idle_per_step(ctx, group: str):
    """A group's idle seconds over the traced window's beam steps; None
    where the program has no copy-head spans."""
    red = spans.reduce(ctx.trace, GROUPS)
    if red is None or POINTER not in red.count:
        return None
    return spans.idle_per(ctx, group, "steps", GROUPS)


def device_seconds(trace, names: tuple):
    """Device seconds of the traced window's operations whose host launch
    lies, innermost, in one of the spans ``names`` of ``GROUPS``; None
    without a trace or without a ``care.pointer`` span in it."""
    if trace is None or not trace.ops:
        return None
    table = [(max(s, trace.t0), min(t, trace.t1), name)
             for name, s, t, _, _ in trace.cpu if name in GROUPS]
    if not any(name == POINTER for _, _, name in table):
        return None
    launched = [(trace.runtime[corr][1], t - s)
                for _, s, t, corr in trace.ops if corr in trace.runtime]
    inner = spans.innermost(table, [at for at, _ in launched])
    return sum(length for (_, length), name in zip(launched, inner)
               if name in names) / 1e9


def ms_per_batch(ctx, names: tuple):
    """``device_seconds`` in ms over the traced window's batches."""
    s = device_seconds(ctx.trace, names)
    batches = ctx.trace_samples["batches"] if ctx.trace_samples else 0
    return None if s is None or not batches else 1e3 * s / batches
