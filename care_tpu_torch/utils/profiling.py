"""Profiling and latency instrumentation.

Port of ``care_tpu/utils/profiling.py`` (reference ``translate.py:29-64``:
batch-1 wall-clock timing appended to ``latency.txt``):

* ``trace_annotation(name)``: a ``torch.profiler.record_function`` range,
  so that encode and decode phases show up by name in a profile;
* ``profile_trace(log_dir)``: a ``torch.profiler.profile`` of a block (the
  host, and the card when one is in use) whose Chrome trace is written to
  ``<log_dir>/trace.json`` when the block ends;
* ``LatencyRecorder``: the reference's ``latency.txt`` row contract.
"""

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace_annotation(name: str):
    with torch.profiler.record_function(name):
        yield


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
