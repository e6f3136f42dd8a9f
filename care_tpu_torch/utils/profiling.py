"""Profiling and latency instrumentation.

Port of ``care_tpu/utils/profiling.py`` (reference ``translate.py:29-64``:
batch-1 wall-clock timing appended to ``latency.txt``):

* ``trace_annotation(name)``: the port's one span, a
  ``torch.profiler.record_function`` range while a profiler runs and a
  shared null context otherwise, so that the decode's layers show up by
  name in a profile and cost about a microsecond when none runs;
* ``profile_trace(log_dir)``: a ``torch.profiler.profile`` of a block (the
  host, and the card when one is in use) whose Chrome trace is written to
  ``<log_dir>/trace.json`` when the block ends;
* ``LatencyRecorder``: the reference's ``latency.txt`` row contract.
"""

import contextlib
import os
import time

import torch


_NO_SPAN = contextlib.nullcontext()


def trace_annotation(name: str):
    """A span named ``name`` when a profiler runs (``profile_trace``, the
    trainer's ``profile_dir``, a benchmark's traced window), else the
    shared null context. A plain function, not a generator: the path
    without a profiler takes one check."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """Profile the block; yields the ``torch.profiler.profile`` object and
    writes its trace under ``log_dir`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class LatencyRecorder:
    """Accumulates per-sample wall-clock and appends the reference's
    ``latency.txt`` row: ``method\ttask\ttotal\tn\tavg``."""

    def __init__(self, method: str = "", task: str = ""):
        self.method = method
        self.task = task
        self.total = 0.0
        self.n = 0

    @contextlib.contextmanager
    def measure(self, n: int = 1):
        t0 = time.perf_counter()
        yield
        self.total += time.perf_counter() - t0
        self.n += n

    @property
    def avg(self) -> float:
        return self.total / max(self.n, 1)

    def append_to(self, path: str = "latency.txt"):
        with open(path, "a") as f:
            f.write(f"{self.method}\t{self.task}\t{self.total}\t{self.n}\t"
                    f"{self.avg}\n")
