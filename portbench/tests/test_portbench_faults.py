"""Each fault a serving cell can have, planted under a run at test size on
the CPU, makes ``correct`` come out false: the decode step's state left
unchanged, and a token altered where the beam produces it. A run on one
chip exchanges nothing between chips, and a serving cell has no batch
mean, so those faults have no place here. The limits are the cells' own
(``portbench/limits``)."""

import time

import pytest
import torch

import tiny
from portbench import run


def _run(workload, patch):
    b, c, cfg, mx = tiny.cell(workload)
    return run.run_cell(b, c, cfg, mx, 2**31 + 5, 0.6, False, "cpu",
                        t_start=time.perf_counter(), patch=patch)


def _stale_cache(driver, monkeypatch):
    from care_tpu_torch.models import decoders

    step = decoders.TransformerDecoder.decode_step

    def unchanged(self, token_ids, position, state):
        copy = {"layers": [dict(l, self_k=l["self_k"].clone(),
                                self_v=l["self_v"].clone())
                           for l in state["layers"]],
                "aux": state["aux"]}
        h, _ = step(self, token_ids, position, copy)
        return h, state
    monkeypatch.setattr(decoders.TransformerDecoder, "decode_step",
                        unchanged)


def _altered_token(driver, monkeypatch):
    import importlib
    bs = importlib.import_module("care_tpu_torch.decoding.beam_search")
    topk = bs.fused_head_beam_topk

    def altered(*args, **kwargs):
        scores, ids = topk(*args, **kwargs)
        return scores, ids + 1
    monkeypatch.setattr(bs, "fused_head_beam_topk", altered)


@pytest.mark.parametrize("workload", tiny.CELLS)
@pytest.mark.parametrize("fault", [_stale_cache, _altered_token])
def test_serving_faults_fail(workload, fault, monkeypatch):
    b, c, cfg, mx = tiny.cell(workload)

    def patch(driver):
        fault(driver, monkeypatch)
        driver.results.clear()
    out = _run(workload, patch)
    assert not out["correct"], out["checks"]
