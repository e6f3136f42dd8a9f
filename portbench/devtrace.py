"""The device trace of a ``--trace 1`` run: ``torch.profiler`` (CUPTI) over
the measured window, reduced to device intervals, kernel times by name,
copies, launches, host ranges and the device's idle gaps.

The window is the host range ``portbench.window`` that the driver opens
around its loop; every interval is clipped to it. Device operations are
kernels, copies and memsets; the device-track copies of host annotations
are not operations. An idle gap is named after what the host did when it
ended: the benchmark's range around that moment and the innermost host
operation that launched the next device operation.
"""

import bisect
import re
import time

import torch

WINDOW = "portbench.window"
NAMED_GAPS = 100_000


def _activity(e) -> str:
    try:
        return str(e.activity_type()).lower()
    except (AttributeError, RuntimeError):
        return ""


class Tracer:
    """A profiler that covers the window when enabled, and nothing
    otherwise."""

    def __init__(self, enabled: bool, device):
        self.enabled = enabled
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None

    def start(self):
        if not self.enabled:
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()

    def stop(self):
        if self.prof is not None:
            if self.cuda:
                torch.cuda.synchronize()
            self.prof.stop()

    def summary(self):
        if self.prof is None:
            return None
        t0 = time.perf_counter()
        s = TraceSummary(self.prof.profiler.kineto_results.events())
        s.reduce_seconds = time.perf_counter() - t0
        self.prof = None
        return s


class TraceSummary:
    def __init__(self, events):
        cpu, dev = [], []
        for e in events:
            start = e.start_ns()
            end = start + e.duration_ns()
            name = e.name()
            act = _activity(e)
            if e.device_type() == torch.autograd.DeviceType.CPU:
                cpu.append((name, start, end, e.correlation_id(), act))
            else:
                dev.append((name, start, end, e.correlation_id(), act))
        # a host range's copy on the device track bears the range's name
        # (``Optimizer.step#Adam.step``); no kernel or copy is named as a
        # host event is
        annot = {c[0] for c in cpu}
        win = [(s, t) for n, s, t, _, _ in cpu if n == WINDOW]
        if not win:
            raise RuntimeError("the trace holds no window range")
        self.t0, self.t1 = win[0]
        self.window_s = (self.t1 - self.t0) / 1e9
        self.cpu = [c for c in cpu if c[2] > self.t0 and c[1] < self.t1]
        self.runtime = {c[3]: c for c in self.cpu
                        if c[0].startswith(("cuda", "cu"))}
        self.ranges = [c for c in self.cpu
                       if c[0].startswith("portbench.") and c[0] != WINDOW]
        # host operations by start, for the innermost one around a moment
        self.host_ops = sorted(
            (c for c in self.cpu if not c[0].startswith(("portbench.", "cu"))
             and "runtime" not in c[4]), key=lambda c: c[1])
        self.host_starts = [c[1] for c in self.host_ops]
        ops = []
        for name, s, t, corr, act in dev:
            if name in annot or "annotation" in act:
                continue
            s, t = max(s, self.t0), min(t, self.t1)
            if t > s:
                ops.append((name, s, t, corr))
        ops.sort(key=lambda o: o[1])
        self.ops = ops
        self.kernels = [o for o in ops if not o[0].startswith(("Memcpy",
                                                               "Memset"))]
        self.copies = [o for o in ops if o[0].startswith("Memcpy")]
        self.reduce_seconds = 0.0

    # ---- device time --------------------------------------------------
    def busy_s(self) -> float:
        busy, end = 0, self.t0
        for _, s, t, _ in self.ops:
            if t <= end:
                continue
            busy += t - max(s, end)
            end = t
        return busy / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(t - s for n, s, t, _ in self.kernels if rx.search(n)) / 1e9

    def kernel_count(self) -> int:
        return len(self.kernels)

    def copy_seconds(self, direction: str) -> float:
        return sum(t - s for n, s, t, _ in self.copies
                   if direction in n) / 1e9

    # ---- breakdown ----------------------------------------------------
    def top_ops(self, n: int = 10) -> list:
        by = {}
        for name, s, t, _ in self.ops:
            key = name[:120]
            by[key] = by.get(key, 0) + (t - s)
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _host_at(self, at: int, launch=None) -> str:
        """The benchmark's range around ``at`` and the innermost host
        operation that holds the launch (or ``at``)."""
        point = launch if launch is not None else at
        outer = None
        for name, s, t, _, _ in self.ranges:
            if s <= point <= t and (outer is None or s >= outer[1]):
                outer = (name, s)
        inner = None
        i = bisect.bisect_right(self.host_starts, point) - 1
        # operations nest, so the latest started one that still runs is the
        # innermost; a bounded look back keeps a long trace cheap
        for c in self.host_ops[max(0, i - 2000):i + 1][::-1]:
            if c[2] >= point:
                inner = c
                break
        parts = [p[0] for p in (outer, inner) if p is not None]
        return " / ".join(parts) or "host (no operation)"

    def idle_gaps(self, n: int = 10) -> list:
        """Idle time between device operations, summed by what the host
        was doing when each gap ended; the ``n`` largest."""
        gaps, end = [], self.t0
        for name, s, t, corr in self.ops:
            if s > end:
                launch = self.runtime.get(corr)
                gaps.append((s - end, s, launch[1] if launch else None))
            end = max(end, t)
        if self.t1 > end:
            gaps.append((self.t1 - end, self.t1, None))
        # name the largest gaps first; the scan of the host events is the
        # costly part, so past NAMED_GAPS the short ones go under one name
        gaps.sort(key=lambda g: -g[0])
        by = {}
        for i, (length, at, launch) in enumerate(gaps):
            key = (self._host_at(at, launch) if i < NAMED_GAPS
                   else "shorter gaps (not named)")
            by[key] = by.get(key, 0) + length
        return [[k, v / 1e9] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]
