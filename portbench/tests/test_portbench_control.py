"""The control at test size on the CPU: the reference computed in TF32
(operands rounded to TF32's mantissa) in the program's place fails one of
each cell's numbers, on three seeds, while the program passes them. The
readings at the cells' own
size come from ``portbench/control.py`` on the card (``-m gpu``:
``test_portbench_card.py``)."""

import json
import os

import pytest

import tiny
from portbench import control

SEEDS = (11, 2**31 + 3, 90001)


def _limits(workload):
    with open(os.path.join(tiny.HERE, "limits", workload + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("workload", tiny.CELLS)
def test_control_fails_and_program_passes(workload):
    limits = _limits(workload)
    for line in control.readings(workload, SEEDS, 0.5, device="cpu",
                                 cell=tiny.cell(workload)):
        r = line["readings"]
        assert all(r[k] <= v for k, v in limits.items()), r
        assert any(r["control_" + k] > v for k, v in limits.items()), r
