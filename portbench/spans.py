"""The program's spans (``care.*`` host ranges, opened by
``care_tpu_torch/utils/profiling.py:trace_annotation`` while the profiler
runs) in a traced window, reduced once per run: each idle gap of the
device, as ``devtrace.TraceSummary.idle_gaps`` finds them, goes to the
innermost span that holds the host launch ending it (the device
operation's start where the trace pairs no launch), and the tail gap to
the window's end lies outside every span. The spans' groups partition
the window's idle time:

* ``bookkeeping``: the beam's own work, ``care.beam.live`` (the per-step
  read of the loop condition), ``care.beam.reorder``, ``care.beam.finish``;
* ``decoder``: ``care.decoder.step``, ``care.head.topk`` and the rest of
  ``care.beam.step``;
* ``batch_edges``: ``care.encode``, ``care.beam.init``,
  ``care.beam.final``, ``care.collect`` (and its ``.fetch``) and the rest
  of ``care.dispatch``;
* ``outside``: no span, the caller's copies and loop.

That is the default table, ``GROUPS``, of the autoregressive decode. A
reader of another kind's spans passes a table of its own (span name ->
group) from a file of its own; each table's reduction is kept apart on the
trace. A program without a table's spans gives no reduction (None), and
its readers nothing to read.
"""

GROUPS = {
    "care.beam.live": "bookkeeping",
    "care.beam.reorder": "bookkeeping",
    "care.beam.finish": "bookkeeping",
    "care.decoder.step": "decoder",
    "care.head.topk": "decoder",
    "care.beam.step": "decoder",
    "care.encode": "batch_edges",
    "care.beam.init": "batch_edges",
    "care.beam.final": "batch_edges",
    "care.collect": "batch_edges",
    "care.collect.fetch": "batch_edges",
    "care.dispatch": "batch_edges",
}
OUTSIDE = "outside"


class Reduction:
    """Idle seconds by group, and each span name's count and host seconds,
    of one traced window."""

    def __init__(self, idle_s: dict, count: dict, host_s: dict):
        self.idle_s, self.count, self.host_s = idle_s, count, host_s


def _gaps(trace) -> list:
    """(moment, length in ns) of every idle gap of the window: the moment
    is the host launch that ended the gap (the operation's start where no
    launch is paired, None for the tail)."""
    gaps, end = [], trace.t0
    for _, s, t, corr in trace.ops:
        if s > end:
            launch = trace.runtime.get(corr)
            gaps.append((launch[1] if launch else s, s - end))
        end = max(end, t)
    if trace.t1 > end:
        gaps.append((None, trace.t1 - end))
    return gaps


def innermost(spans: list, moments: list) -> list:
    """The innermost of ``spans`` ((start, end, name), nested as one
    thread's ranges nest) that holds each moment, or None; one sweep over
    both, sorted by time."""
    spans = sorted(spans, key=lambda sp: (sp[0], -sp[1]))
    order = sorted(range(len(moments)), key=lambda k: moments[k])
    out, stack, i = [None] * len(moments), [], 0
    for k in order:
        at = moments[k]
        while i < len(spans) and spans[i][0] <= at:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < at:
            stack.pop()
        out[k] = stack[-1][2] if stack else None
    return out


def reduce(trace, groups: dict = GROUPS):
    """The window's reduction by the span table ``groups`` (span name ->
    group), made once per table and kept on ``trace``; None without a
    trace or without the table's spans in it."""
    if trace is None:
        return None
    if not hasattr(trace, "care_spans"):
        trace.care_spans = {}
    key = tuple(sorted(groups.items()))
    if key not in trace.care_spans:
        trace.care_spans[key] = _reduce(trace, groups)
    return trace.care_spans[key]


def _reduce(trace, groups):
    spans = [(max(s, trace.t0), min(t, trace.t1), name)
             for name, s, t, _, _ in trace.cpu if name in groups]
    if not spans:
        return None
    count, host_s = {}, {}
    for s, t, name in spans:
        count[name] = count.get(name, 0) + 1
        host_s[name] = host_s.get(name, 0.0) + (t - s) / 1e9
    idle_s = dict.fromkeys(list(set(groups.values())) + [OUTSIDE], 0.0)
    gaps = _gaps(trace)
    inner = innermost(spans, [at for at, _ in gaps if at is not None])
    held = iter(inner)
    for at, length in gaps:
        name = next(held) if at is not None else None
        idle_s[groups[name] if name else OUTSIDE] += length / 1e9
    return Reduction(idle_s, count, host_s)


def idle_per(ctx, group: str, per: str, groups: dict = GROUPS):
    """A group of ``groups``' idle seconds over the traced window's beam
    steps (``per="steps"``) or batches (``"batches"``); None where there is
    nothing to read."""
    red = reduce(ctx.trace, groups)
    if red is None or not ctx.trace.ops:
        return None
    n = (ctx.trace_counts.get("translator.beam_steps", 0) if per == "steps"
         else ctx.trace_samples["batches"])
    return red.idle_s[group] / n if n else None
