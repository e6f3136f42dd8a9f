"""The plain reference against ``care_tpu_torch`` at test size on the CPU:
the same weights give the same concept scores and logits, and a run of
every cell on the CPU is correct by its comparison."""

import time

import pytest
import torch

import tiny
from portbench import lookup, program, run
from portbench.reference import care


def _pair(config, seed=3):
    cfg = tiny.config(config)
    m = cfg["model"]
    P = lookup.module("weights", cfg["weights"]).make(
        care.param_shapes(m), seed, "cpu", m)
    model = program.build_model(program.program_opt(cfg), P, "cpu")
    return m, P, model


def _feats(m, B, seed=4):
    g = torch.Generator().manual_seed(seed)
    return {c: torch.randn(B, m["rows"][c], m["dims"][c], generator=g)
            for c in m["modality"]}


@pytest.mark.parametrize("config", [c["name"] for c in
                                    tiny.bench()["configs"]])
@torch.no_grad()
def test_forward_matches_program(config):
    m, P, model = _pair(config)
    feats = _feats(m, 3)
    ids = torch.randint(6, m["vocab_size"], (3, 7))
    ids[:, 0] = care.BOS
    enc = model.encoding_phase([feats[c] for c in m["modality"]])
    states, preds = care.concept_scores(P, m, feats)
    assert torch.equal(preds, enc["preds_attr"])
    labels = care.concept_order(preds, m["use_attr_topk"])
    assert torch.equal(labels, enc["semantic_labels"])
    ref_enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    inputs = model.prepare_inputs_for_decoder(enc, {})
    torch.testing.assert_close(ref_enc, inputs["encoder_hidden_states"],
                               rtol=0, atol=1e-6)
    got = model.decoding_phase(ids, inputs)["logits"]
    want = care.linear(care.decode(P, m, ids, ref_enc, gsg),
                       P["cls_head.tgt_word_prj.weight"])
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
