"""Each fault a serving cell can have, planted under a run at test size on
the CPU, makes ``correct`` come out false. The faults are those the cell's
judge names (``FAULTS`` of ``portbench/judges/<judge>.py``); the CARE
judge's are the decode step's state left unchanged and a token altered
where the beam produces it. The limits are the cells' own
(``portbench/limits``)."""

import time

import pytest

import tiny
from portbench import lookup, run


def _run(workload, patch):
    b, c, cfg, mx = tiny.cell(workload)
    return run.run_cell(b, c, cfg, mx, 2**31 + 5, 0.6, False, "cpu",
                        t_start=time.perf_counter(), patch=patch)


def _judge(workload):
    return lookup.module("judges", tiny.cell(workload)[2]["judge"])


@pytest.mark.parametrize("workload,fault", [
    (w, name) for w in tiny.CELLS for name in _judge(w).FAULTS])
def test_serving_faults_fail(workload, fault, monkeypatch):
    plant = _judge(workload).FAULTS[fault]

    def patch(driver):
        plant(driver, monkeypatch.setattr)
        driver.results.clear()
    out = _run(workload, patch)
    assert not out["correct"], out["checks"]
