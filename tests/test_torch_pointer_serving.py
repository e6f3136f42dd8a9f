"""PointerGen CARE on the port's serving path
(``get_translator(opt).translate_batches`` -> ``_dispatch_dense``, the
copy head in ``Captioner.decode_step``) against the benchmark's plain
reference, ``portbench/reference/pointer.py``, on the CPU at the
benchmark's test size (``portbench/tests/tiny.py``), with weights drawn
from a seed by the benchmark's weights maker:

* the KV-cached step's log-probabilities (``log(probs + 1e-9)``), the
  retrieved captions enlarged to the beam's rows, against the reference's
  full forward at every position; the same step on a bf16 copy of the
  model falls outside the tolerance;
* a served beam's scores against the reference's length-normalised
  log-probabilities of its tokens, every caption of two batches;
* under a profiler, one ``care.pointer`` span a beam step inside its
  ``care.decoder.step``, one ``care.pointer.kv`` a batch inside its
  ``care.beam.init``, and ``models.pointer.kv_launches`` raised once a
  batch; the decode under the profiler is bitwise the one without it;
* the retrieved captions' keys and values projected once a batch: row
  n * beam + k of the beam's inputs holds video n's projections, the
  served beams equal those of a decode whose every step projects the
  enlarged raw captions, and ``decode_step`` given raw captions projects
  them at each call;
* the planted faults (the copy gate at 0, the retrieved captions tiled
  over the beam instead of repeated, the KV cache left stale) caught by
  the cell's comparison.

Imports neither JAX nor the JAX package.
"""

import copy
import importlib
import time

import pytest
import torch

from care_tpu_torch.decoding import get_translator
from portbench import program, run
from portbench.generators import retrieved_captions
from portbench.judges import pointer as judge
from portbench.reference import care
from portbench.reference import pointer as ref
from portbench.tests import tiny
from test_torch_pointer_card import decode_projecting_every_step

CONFIG, CELL = "msrvtt-pointergen-care-vit", "pointergen.serve.b64"
pointer_module = importlib.import_module("care_tpu_torch.models.pointer")

# Log-probabilities are about log(1 / V) ~ -6 here; the step and the
# reference sum in other orders (the KV cache against the full forward,
# the scatter of repeated ids against a product with their one-hot rows),
# which moves f32 results by a few units in the last place, ~1e-6. The
# tolerance leaves ten times that; bf16's 8-bit mantissa moves them by
# ~1e-2, far outside it.
STEP_TOL = 1e-5
# A beam score is the mean of at most max_len - 1 step log-probabilities,
# so its rounding is that of one step.
SCORE_TOL = 1e-5


@pytest.fixture(scope="module")
def cell():
    b, c, cfg, mx = tiny.cell(CELL)
    model, P = judge.model_and_weights(cfg, 2**31 + 17)
    return cfg, mx, model, P


def _step_log_probs(model, m, inputs, tokens, beam, dtype):
    """The decode step's scores [rows, L, V], one token sequence a row,
    row n * beam + k a beam row of video n, on a copy of the model in
    ``dtype``."""
    model = copy.deepcopy(model).to(dtype)
    dec_in = {k: v.to(dtype) if v.is_floating_point() else v
              for k, v in inputs.items()}
    state = model.init_decode_state(dec_in, m["max_len"], beam)
    step_in = {k: dec_in[k].repeat_interleave(beam, dim=0)
               for k in ("ret_text_embs", "ret_input_ids")}
    out = []
    for t in range(tokens.shape[1]):
        lp, state, is_prob = model.decode_step(tokens[:, t], t, state,
                                               step_in)
        assert is_prob
        out.append(lp.float())
    return torch.stack(out, dim=1)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@torch.no_grad()
def test_step_log_probs_against_the_reference(cell, dtype):
    cfg, _, model, P = cell
    m = cfg["model"]
    B, beam, V = 3, m["beam_size"], m["vocab_size"]
    feats, ret = judge.inputs(m, B, 21)
    enc = model.encoding_phase([ret if c == "t" else feats[c]
                                for c in m["modality"]])
    inputs = model.prepare_inputs_for_decoder(enc, {})
    g = torch.Generator().manual_seed(22)
    tokens = torch.randint(6, V, (B * beam, m["max_len"]), generator=g)
    tokens[:, 0] = care.BOS
    # the reference: each row's own video, its captions not enlarged
    states, preds = ref.concept_scores(P, m, feats)
    labels = care.concept_order(preds, m["use_attr_topk"])
    r_enc, gsg = care.decoder_inputs(P, m, states, preds, labels)
    video = torch.arange(B * beam) // beam
    hidden = care.decode(P, m, tokens, r_enc[video], gsg[video])
    embs = ref.retrieved_embs(P, m, ret)
    want = ref.log_probs(P, m, hidden, embs[video], ret[video])
    got = _step_log_probs(model, m, inputs, tokens, beam,
                          torch.float32 if dtype == "f32" else torch.bfloat16)
    gap = float((got - want).abs().max())
    if dtype == "f32":
        assert gap <= STEP_TOL, gap
    else:
        assert gap > 10 * STEP_TOL, gap


def _serve(cfg, mx, model, seed, batches=2):
    """The cell's batches from ``seed`` through ``translate_batches``:
    (the translator, the pool, [(pool index, row, tokens, score)] of
    every caption)."""
    m = cfg["model"]
    pool = retrieved_captions.make(m, mx, seed, "cpu")[:batches]
    tr = get_translator(program.program_opt(cfg), device="cpu")
    feeds = [{"feats": [torch.as_tensor(x) for x in b]} for b in pool]
    served = []
    for b, (_, (hyps, scores)) in enumerate(
            tr.translate_batches(model, feeds)):
        served += [(b, r, hyps[r][0], scores[r][0])
                   for r in range(len(hyps))]
    return tr, pool, served


@pytest.mark.parametrize("seed", [2**31 + 3, 40503])
def test_served_scores_against_the_reference(cell, seed):
    cfg, mx, model, P = cell
    m = cfg["model"]
    tr, pool, served = _serve(cfg, mx, model, seed)
    assert len(served) == 2 * mx["batch"]
    assert all(len(tokens) > 0 for _, _, tokens, _ in served)
    r = judge.serve_readings(P, m, dict(enumerate(pool)), served, "cpu")
    assert r["score_gap"] <= SCORE_TOL and r["rank_gap"] <= SCORE_TOL, r
    assert tr.beam_steps == 2 * (m["max_len"] - 1)


def _care_spans(prof):
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith("care.")
                   and e.device_type() == torch.autograd.DeviceType.CPU),
                  key=lambda s: (s[1], -s[2]))


def _within(spans, name, outer):
    """Each span ``name``, and whether a span ``outer`` holds it."""
    outs = [s for s in spans if s[0] == outer]
    return [any(o[1] <= s[1] and s[2] <= o[2] for o in outs)
            for s in spans if s[0] == name]


def test_copy_head_spans_and_kv_launches(cell):
    cfg, mx, model, _ = cell
    before = pointer_module.kv_launches
    tr, _, plain = _serve(cfg, mx, model, 7)
    assert pointer_module.kv_launches - before == tr.edge_passes == 2
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        tr2, _, traced = _serve(cfg, mx, model, 7)
    spans = _care_spans(prof)
    steps = sum(1 for s in spans if s[0] == "care.beam.step")
    assert steps == tr2.beam_steps == 2 * (cfg["model"]["max_len"] - 1)
    inside = _within(spans, "care.pointer", "care.decoder.step")
    assert len(inside) == steps and all(inside)
    inside = _within(spans, "care.pointer.kv", "care.beam.init")
    assert len(inside) == tr2.edge_passes == 2 and all(inside)
    assert traced == plain


def _batch_inputs(tr, model, feed):
    """A feed's decoder inputs as the translator builds them."""
    return model.prepare_inputs_for_decoder(
        model.encoding_phase(tr._feats(feed)), tr._batch_inputs(feed))


@torch.no_grad()
def test_hoisted_keys_and_values_are_each_videos(cell):
    """The beam's inputs hold, at row n * beam + k, the projections of
    video n's retrieved captions, the same tensors at every step."""
    cfg, mx, model, _ = cell
    m = cfg["model"]
    pool = retrieved_captions.make(m, mx, 11, "cpu")[:1]
    feed = {"feats": [torch.as_tensor(x) for x in pool[0]]}
    tr = get_translator(program.program_opt(cfg), device="cpu")
    seen = []
    hook = model.pointer.register_forward_hook(
        lambda mod, args, kwargs, out: seen.append(kwargs), with_kwargs=True)
    try:
        tr.translate_batch(model, feed)
    finally:
        hook.remove()
    assert len(seen) == tr.beam_steps == m["max_len"] - 1
    assert all("ret_text_embs" not in kw for kw in seen)
    inputs = _batch_inputs(tr, model, feed)
    embs, ids = inputs["ret_text_embs"], inputs["ret_input_ids"]
    B, R, S, D = embs.shape
    beam = m["beam_size"]
    k, v = model.pointer.attention.project_kv(embs.reshape(B * R, S, D))
    video = torch.arange(B * beam) // beam
    for got, want in ((seen[0]["ret_k"], k), (seen[0]["ret_v"], v)):
        assert got.shape == (B * beam, R, *want.shape[1:])
        assert torch.equal(got, want.reshape(B, R, *want.shape[1:])[video])
    assert not torch.equal(seen[0]["ret_k"][0], seen[0]["ret_k"][beam])
    assert torch.equal(seen[0]["ret_input_ids"], ids[video])
    for kw in seen[1:]:
        assert all(kw[n] is seen[0][n]
                   for n in ("ret_k", "ret_v", "ret_input_ids"))


@pytest.mark.parametrize("seed", [2**31 + 9, 613])
@torch.no_grad()
def test_hoisted_decode_equals_projecting_at_every_step(cell, seed):
    """A served batch against the same beam search whose every step hands
    ``decode_step`` the raw captions enlarged to the beam's rows, so that
    the copy head projects them at each step: the same tokens, scores
    within 1e-6."""
    cfg, mx, model, _ = cell
    m = cfg["model"]
    pool = retrieved_captions.make(m, mx, seed, "cpu")[:1]
    feed = {"feats": [torch.as_tensor(x) for x in pool[0]]}
    tr = get_translator(program.program_opt(cfg), device="cpu")
    want_h, want_s = tr.translate_batch(model, feed)
    before = pointer_module.kv_launches
    got_h, got_s = decode_projecting_every_step(tr, model, feed)
    assert pointer_module.kv_launches - before == m["max_len"] - 1
    assert got_h == want_h
    gap = max(abs(a - b) for ga, wa in zip(got_s, want_s)
              for a, b in zip(ga, wa))
    assert gap <= 1e-6, gap


@torch.no_grad()
def test_decode_step_projects_raw_captions_at_each_call(cell):
    """``decode_step`` given raw captions projects them once a call, given
    their projections not at all, and both give the same log-probs."""
    cfg, _, model, _ = cell
    m = cfg["model"]
    beam = m["beam_size"]
    feats, ret = judge.inputs(m, 2, 23)
    inputs = model.prepare_inputs_for_decoder(model.encoding_phase(
        [ret if c == "t" else feats[c] for c in m["modality"]]), {})
    raw = {n: inputs[n].repeat_interleave(beam, dim=0)
           for n in ("ret_text_embs", "ret_input_ids")}
    before = pointer_module.kv_launches
    memory = model.pointer.project_memory(inputs["ret_text_embs"])
    hoisted = {n: t.repeat_interleave(beam, dim=0) for n, t in
               dict(memory, ret_input_ids=inputs["ret_input_ids"]).items()}
    assert pointer_module.kv_launches - before == 1
    tokens = torch.full((2 * beam,), care.BOS, dtype=torch.long)
    states = [model.init_decode_state(inputs, m["max_len"], beam)
              for _ in range(2)]
    for t in range(3):
        before = pointer_module.kv_launches
        a, states[0], _ = model.decode_step(tokens, t, states[0], raw)
        assert pointer_module.kv_launches - before == 1
        b, states[1], _ = model.decode_step(tokens, t, states[1], hoisted)
        assert pointer_module.kv_launches - before == 1
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
        tokens = a.argmax(dim=-1)


@pytest.mark.parametrize("fault", sorted(judge.FAULTS))
def test_planted_faults_are_caught(fault, monkeypatch):
    b, c, cfg, mx = tiny.cell(CELL)

    def patch(driver):
        judge.FAULTS[fault](driver, monkeypatch.setattr)
        driver.results.clear()
    out = run.run_cell(b, c, cfg, mx, 2**31 + 5, 0.3, False, "cpu",
                       t_start=time.perf_counter(), patch=patch)
    assert out["attempted"] > 0
    assert not out["correct"], out["checks"]
