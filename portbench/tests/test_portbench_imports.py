"""Nothing the benchmark runs loads JAX, optax, flax or the JAX package:
a run of every cell at test size, in a process of its own, then its
modules by their top-level names (``care_tpu_torch`` is not
``care_tpu``)."""

import subprocess
import sys

from tiny import ROOT

SCRIPT = r"""
import sys, time
sys.path[:0] = [{root!r}, {root!r} + "/portbench/tests"]
import tiny
from portbench import control, run
for w in ("flagship.serve.b64", "longkeys.serve.b64", "flagship.latency.b1"):
    b, c, cfg, mx = tiny.cell(w)
    run.run_cell(b, c, cfg, mx, 5, 0.5, True, "cpu",
                 t_start=time.perf_counter())
print(run.forbidden_modules())
print(sorted(m for m in sys.modules if m.split(".")[0] == "care_tpu"))
"""


def test_no_jax_after_a_run():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=ROOT)],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    assert lines[-2:] == ["[]", "[]"], out.stdout[-2000:]


def test_forbidden_names_are_whole():
    from portbench import run
    saved = dict(sys.modules)
    try:
        sys.modules["care_tpu_torch_probe"] = sys
        sys.modules["jaxlib_probe.x"] = sys
        assert "care_tpu" not in run.forbidden_modules()
        sys.modules["care_tpu.probe"] = sys
        assert "care_tpu" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
