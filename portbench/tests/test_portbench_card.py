"""On the card (``python -m pytest portbench/tests -m gpu``): each cell at
its own size, one seed, a short window: the program's readings pass the
cell's limits and the control (the reference in TF32) fails one of them."""

import json
import os

import pytest

import tiny
from portbench import control


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on the card with -m gpu")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("workload", tiny.CELLS)
def test_cell_at_size(card, workload):
    with open(os.path.join(tiny.HERE, "limits", workload + ".json")) as f:
        limits = json.load(f)
    for line in control.readings(workload, [2**31 + 99], 2.0, device=card):
        r = line["readings"]
        assert line["failed"] == 0
        assert all(r[k] <= v for k, v in limits.items()), r
        assert any(r["control_" + k] > v for k, v in limits.items()), r
