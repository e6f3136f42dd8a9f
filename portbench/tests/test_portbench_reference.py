"""The plain reference against ``care_tpu_torch`` at test size on the CPU:
the same weights give the same forward, as each configuration's judge
checks it (``check_forward``), and a run of every cell on the CPU is
correct by its comparison."""

import time

import pytest

import tiny
from portbench import lookup, run


@pytest.mark.parametrize("config", [c["name"] for c in
                                    tiny.bench()["configs"]])
def test_forward_matches_program(config):
    cfg = tiny.config(config)
    lookup.module("judges", cfg["judge"]).check_forward(cfg, 3)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_cpu_run_is_correct(workload):
    b, c, cfg, mx = tiny.cell(workload)
    # tighter than the cells' own limits: at test size the sound readings
    # are rounding of fewer terms
    limits = {k: 1e-5 for k in run.limits_for(workload)}
    out = run.run_cell(b, c, cfg, mx, 2**31 + 11, 1.0, False, "cpu",
                       t_start=time.perf_counter(), limits=limits)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    e2e = {m["name"] for m in b["end_to_end"]
           if c["name"] in m.get("workloads", [c["name"]])}
    assert set(out["metrics"]) == e2e


def test_cpu_run_without_a_card_fails_clearly():
    import subprocess
    import sys
    for w in [w["name"] for w in tiny.bench()["workloads"]]:
        p = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                            w, "--seed", "1", "--seconds", "2", "--trace",
                            "0"], capture_output=True, text=True,
                           cwd=tiny.ROOT, env={"CUDA_VISIBLE_DEVICES": "",
                                               "PATH": "/usr/bin:/bin"},
                           timeout=300)
        assert p.returncode == 2 and p.stdout == ""
        assert "needs 1 CUDA card" in p.stderr
