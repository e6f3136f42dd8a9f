"""The AR beam step and the batch's edges run over static tensors and, on
the card, replayed as one CUDA graph each (``decoding/step_graphs.py``):
on the CPU the static bodies, run eagerly, give exactly the eager
dispatch's beams; the dense, ensemble, RNN, pointer and model-axis decodes
keep the eager loop; a model whose tensors moved starts a new static
decode. The ``gpu`` tests hold the replays to the eager loop bit for bit
at full width, and their counters and profiler events to the eager
loop's. This file imports neither JAX nor ``care_tpu``, so the ``gpu`` run
can collect it.
"""

import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import beam_search, get_translator
from care_tpu_torch.decoding import translator as translator_module
from care_tpu_torch.decoding.step_graphs import StepGraphs
from care_tpu_torch.models import build_captioner
from care_tpu_torch.ops import beam_bookkeeping as bb
from care_tpu_torch.ops import flash_attention as fa
from care_tpu_torch.ops import fused_head_topk as fht

MSRVTT = {"dataset": "MSRVTT", "feats": "ViT", "decoder_modality_flags": "VA",
          "predictor_modality_flags": "VAT", "vocab_size": 40}
# the versatility script's commands (``exp_versatility_of_CARE.sh``)
VERSATILITY = {"arch": "base", "modality": "ami"}
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _opt(method="Transformer", task="CARE", command=None, **extra):
    """A command's options at test size, dropout off."""
    opt = get_opt(dict(MSRVTT, method=method, task=task, **(command or {})),
                  read_vocab=False, resolve_paths=False)
    dim = 4 * opt["num_attention_heads"]
    opt.update(dim_hidden=dim, intermediate_size=2 * dim, n_frames=4,
               max_len=12, attribute_prediction_k=16, use_attr_topk=4,
               retrieval_topk=4, hidden_dropout_prob=0.0,
               encoder_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
               **extra)
    for char in "amir":
        if opt.get(f"dim_{char}"):
            opt[f"dim_{char}"] = max(4, opt[f"dim_{char}"] // 64)
    return opt


def _model(opt, seed=3):
    """Random weights whose beams end at several lengths: the head's EOS
    row is 0.8 x the row of token 37."""
    model = build_captioner(opt, device="cpu", seed=seed).eval()
    with torch.no_grad():
        W = model.cls_head.tgt_word_prj.weight
        W[constants.EOS] = 0.8 * W[37]
    return model


def _feats(opt, n, seed):
    rs = np.random.RandomState(seed)
    feats = []
    for c in opt["modality"]:
        if c == "t":
            ids = rs.randint(4, 12, (n, opt["retrieval_topk"],
                                     opt["max_len"]))
            feats.append(ids.astype(np.int64))
        else:
            feats.append(rs.randn(n, opt["retrieval_topk"] if c == "r" else
                                  opt["n_frames"],
                                  opt[f"dim_{c}"]).astype(np.float32))
    return {"feats": feats}


def _static(tr):
    """``tr`` with its fused decodes on the static path (eagerly here)."""
    tr._graphs_engage = lambda model: True
    return tr


@pytest.fixture(scope="module")
def flagship():
    torch.set_num_threads(2)
    opt = _opt()
    return opt, _model(opt)


@pytest.mark.parametrize("topk", [1, 2])
def test_static_body_equals_the_eager_loop(flagship, topk):
    """Batches of 4, 4, 3 and 1, two in flight through
    ``translate_batches``: tokens and scores equal the eager loop's; each
    shape keeps one static decode, which never aliases a returned
    output."""
    opt, model = flagship
    opt = dict(opt, topk=topk)
    batches = [_feats(opt, n, seed=10 + i) for i, n in
               enumerate((4, 4, 3, 1))]
    eager = get_translator(opt, device="cpu")
    static = _static(get_translator(opt, device="cpu"))
    want = [eager.translate_batch(model, b) for b in batches]
    got = [out for _, out in static.translate_batches(model, batches,
                                                      depth=2)]
    assert got == want
    assert static.beam_steps == eager.beam_steps
    assert static.graph_steps == 0                 # no replay off CUDA
    assert len(static._static) == 3
    lengths = {len(h) for hyps, _ in want for hs in hyps for h in hs}
    assert len(lengths) > 1, lengths               # EOS-finished beams too


def _table(N, max_len, V, seed, eos_from):
    """Per-instance log-probs [N, max_len, V(prev), V(next)]; from step
    ``eos_from`` on every instance favours EOS."""
    rs = np.random.RandomState(seed)
    logits = rs.randn(N, max_len, V, V) * 2.0
    logits[:, eos_from:, :, constants.EOS] += 4.0
    logits -= np.log(np.exp(logits).sum(-1, keepdims=True))
    return torch.as_tensor(logits.astype(np.float32))


def test_static_beam_search_stops_early_and_starts_again():
    """One ``StepGraphs`` through a decode that stops early, one that runs
    to ``max_len`` and the first again: each equals the eager loop."""
    N, K, V, max_len = 3, 3, 11, 9
    graphs = StepGraphs("cpu")
    rows = torch.arange(N).repeat_interleave(K)
    for seed, eos_from in ((1, 2), (2, max_len), (1, 2)):
        table = _table(N, max_len, V, seed, eos_from)
        steps = []

        def step(tok, pos, inst):
            steps.append(pos)
            return table[inst, pos, tok], inst

        kw = dict(batch_size=N, vocab_size=V, beam_size=K, max_len=max_len,
                  topk=2, gather_carry=lambda inst, idx: inst[idx],
                  device="cpu")
        want = beam_search(step, rows.clone(), **kw)
        n_eager, steps[:] = len(steps), []
        got = beam_search(step, rows.clone(), graphs=graphs, **kw)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        assert len(steps) == n_eager
        assert (n_eager < max_len - 1) == (eos_from == 2)


def test_graphs_engage_on_the_card_without_a_model_axis(flagship,
                                                        monkeypatch):
    _, model = flagship
    tr = get_translator(_opt(), device="cpu")
    assert not tr._graphs_engage(model)
    tr.device = torch.device("cuda")               # no card needed to ask
    assert tr._graphs_engage(model)
    for size, engage in ((1, True), (2, False)):
        monkeypatch.setattr(translator_module, "model_axis",
                            lambda m, size=size: types.SimpleNamespace(
                                size=size))
        assert tr._graphs_engage(model) is engage


def _dense_case(kind):
    if kind == "unfused head":
        opt = _opt(fused_head_topk=False)
        return opt, _model(opt)
    if kind == "ensemble":
        opt = _opt()
        return opt, [_model(opt, seed=3), _model(opt, seed=4)]
    if kind == "rnn":
        opt = _opt("SALSTM", "CARE", VERSATILITY)
        return opt, build_captioner(opt, device="cpu", seed=31).eval()
    opt = _opt("PointerGen", "CARE", VERSATILITY)
    return opt, build_captioner(opt, device="cpu", seed=31).eval()


@pytest.mark.parametrize("kind", ["unfused head", "ensemble", "rnn",
                                  "pointer"])
def test_dense_decodes_keep_the_eager_loop(kind):
    """With the static path offered, the dense step's decodes never ask
    for it and equal a plain translator's."""
    opt, model = _dense_case(kind)
    batch = _feats(opt, 3, seed=5)
    asked = []
    tr = get_translator(opt, device="cpu")
    tr._graphs_engage = lambda m: asked.append(m) or True
    got = tr.translate_batch(model, batch)
    assert got == get_translator(opt, device="cpu").translate_batch(model,
                                                                    batch)
    assert not asked and not tr._static and tr.beam_steps > 0


def test_moved_weights_start_a_new_static_decode(flagship):
    """A static decode outlives weights changed in place (its graphs read
    the same addresses) and gives way when a tensor is replaced or another
    model comes: never a stale replay."""
    opt, _ = flagship
    model = _model(opt, seed=7)
    batch = _feats(opt, 4, seed=8)
    tr = _static(get_translator(opt, device="cpu"))

    def decode_and_check():
        got = tr.translate_batch(model, batch)
        assert got == get_translator(opt, device="cpu").translate_batch(
            model, batch)
        (entry,) = tr._static.values()
        return entry

    first = decode_and_check()
    prj = model.decoder.layers[0].intra_attention.query
    with torch.no_grad():
        prj.weight.mul_(1.5)
    assert decode_and_check() is first
    with torch.no_grad():
        prj.weight.data = prj.weight.data * 0.5
    moved = decode_and_check()
    assert moved is not first
    other = _model(opt, seed=9)
    tr.translate_batch(other, batch)
    assert len(tr._static) == 2


def _tiny_bench_model(config):
    """A benchmark configuration at its tests' widths on the CPU, with the
    benchmark's weights (``msrvtt-care-vit-eos``: captions that end at
    several lengths)."""
    from portbench import lookup, program
    from portbench.tests import tiny
    cfg = tiny.config(config)
    m = cfg["model"]
    params = lookup.module("weights", cfg["weights"]).make(
        lookup.module("judges", cfg["judge"]).param_shapes(m), 11, "cpu", m)
    opt = program.program_opt(cfg)
    return opt, program.build_model(opt, params, "cpu"), m


@pytest.mark.parametrize("config", ["msrvtt-care-vit", "msrvtt-care-vit-eos"],
                         ids=["flagship", "eos"])
def test_static_edges_equal_the_eager_dispatch(config):
    """Batches of two sizes in turn, each dispatched before any is
    collected: the outputs of the front edge, steps and ranking run as
    static bodies equal the eager dispatch's bit for bit (tokens, scores,
    lengths, validity), and none is overwritten by a later batch."""
    torch.set_num_threads(2)
    opt, model, m = _tiny_bench_model(config)
    batches = [_bench_feats(m, n, 40 + i)
               for i, n in enumerate((4, 3, 4, 3, 4))]
    eager = get_translator(opt, device="cpu")
    static = _static(get_translator(opt, device="cpu"))
    want = [eager.dispatch(model, b) for b in batches]
    got = [static.dispatch(model, b) for b in batches]
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert len(static._static) == 2
    assert static.beam_steps == eager.beam_steps
    if config.endswith("eos"):
        lengths = {int(n) for out in want for n in out[2].flatten()}
        assert len(lengths) > 1, lengths


class _Replaying(StepGraphs):
    """Off CUDA, each body runs eagerly, and every run of a body after its
    first counts as a replay, as a capture and its replays count on the
    card."""

    def run(self, t, body):
        seen = self.__dict__.setdefault("seen", set())
        body()
        if t in seen and self.on_replay is not None:
            self.on_replay(t)
        seen.add(t)


def test_edge_counters(flagship, monkeypatch):
    """``edge_passes`` counts every AR batch, ``graph_edge_passes`` those
    whose front edge replayed: none off CUDA, or in a dense decode; on the
    card every batch after a shape's first."""
    opt, model = flagship
    batches = [_feats(opt, n, seed=60 + i)
               for i, n in enumerate((4, 3, 4, 4, 3))]
    for tr in (get_translator(opt, device="cpu"),
               get_translator(dict(opt, fused_head_topk=False),
                              device="cpu"),
               _static(get_translator(opt, device="cpu"))):
        list(tr.translate_batches(model, batches))
        assert (tr.edge_passes, tr.graph_edge_passes) == (5, 0)
    monkeypatch.setattr(translator_module, "StepGraphs", _Replaying)
    tr = _static(get_translator(opt, device="cpu"))
    got = [out for _, out in tr.translate_batches(model, batches)]
    assert got == [get_translator(opt, device="cpu").translate_batch(
        model, b) for b in batches]
    assert (tr.edge_passes, tr.graph_edge_passes) == (5, 3)
    assert 0 < tr.graph_steps < tr.beam_steps


@pytest.mark.parametrize("part", ["encoder", "predictor"])
def test_a_moved_edge_tensor_starts_a_new_static_decode(flagship, part):
    """The front edge reads the encoder and the predictor: a tensor of
    either changed in place keeps the static decode, one replaced (a new
    address) starts a new one."""
    opt, _ = flagship
    model = _model(opt, seed=7)
    batch = _feats(opt, 4, seed=8)
    tr = _static(get_translator(opt, device="cpu"))

    def decode_and_check():
        got = tr.translate_batch(model, batch)
        assert got == get_translator(opt, device="cpu").translate_batch(
            model, batch)
        (entry,) = tr._static.values()
        return entry

    first = decode_and_check()
    weight = next(getattr(model, part).parameters())
    with torch.no_grad():
        weight.mul_(1.5)
    assert decode_and_check() is first
    with torch.no_grad():
        weight.data = weight.data * 0.5
    assert decode_and_check() is not first


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bench_model(config, device, seed, eos_clock=False):
    """A benchmark configuration at full width on ``device``, with the
    benchmark's weights from ``seed`` (``eos_clock``: captions that end
    after 8-12 words)."""
    from portbench import lookup, program
    with open(os.path.join(ROOT, "portbench", "configs",
                           config + ".json")) as f:
        cfg = json.load(f)
    m = dict(cfg["model"])
    weights = cfg["weights"]
    if eos_clock:
        with open(os.path.join(ROOT, "portbench", "configs",
                               "msrvtt-care-vit-eos.json")) as f:
            m["eos_clock"] = json.load(f)["model"]["eos_clock"]
        weights = "eos_clock"
    judge = lookup.module("judges", cfg["judge"])
    params = lookup.module("weights", weights).make(
        judge.param_shapes(m), seed, device, m)
    opt = program.program_opt(cfg)
    return opt, program.build_model(opt, params, device), m


def _bench_feats(m, n, seed):
    rng = np.random.default_rng(seed)
    return {"feats": [rng.standard_normal((n, m["rows"][c], m["dims"][c]),
                                          dtype=np.float32)
                      for c in m["modality"]]}


def _counted(tr, model, batches, depth):
    """Outputs of ``batches`` and the counters the decodes moved."""
    before = (fht.launches, fa.fwd_launches, tr.beam_steps)
    out = [o for _, o in tr.translate_batches(model, batches, depth=depth)]
    torch.cuda.synchronize()
    return out, (fht.launches - before[0], fa.fwd_launches - before[1],
                 tr.beam_steps - before[2])


def _eager(opt, device):
    tr = get_translator(opt, device=device)
    tr._graphs_engage = lambda model: False
    return tr


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [64, 17, 1])
def test_replays_equal_the_eager_loop_on_the_card(cuda_device, rows):
    """The flagship at full width: the first batch captures its edges and
    steps, the next two replay them; tokens and scores equal the eager
    loop's bit for bit, and so do K1's launches and the beam steps."""
    opt, model, m = _bench_model("msrvtt-care-vit", cuda_device, 2**31 + 5)
    batches = [_bench_feats(m, rows, 100 + i) for i in range(3)]
    want, want_n = _counted(_eager(opt, cuda_device), model, batches, 1)
    tr = get_translator(opt, device=cuda_device)
    got, got_n = _counted(tr, model, batches, 1)
    assert got == want
    assert got_n == want_n
    assert tr.graph_steps == 2 * (opt["max_len"] - 1)
    assert (tr.edge_passes, tr.graph_edge_passes) == (3, 2)


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["msrvtt-care-vit",
                                    "msrvtt-care-swinbert"],
                         ids=["flagship", "long keys"])
def test_replayed_edges_keep_pending_outputs_on_the_card(cuda_device,
                                                         config):
    """Five batches of 64 dispatched before any is collected, more than a
    stream at depth 2 keeps pending (three): each batch's four output
    tensors, its edges replayed, equal the eager dispatch's bit for bit
    (tokens, scores, lengths, validity) after the later batches ran."""
    opt, model, m = _bench_model(config, cuda_device, 2**31 + 17,
                                 eos_clock=True)
    batches = [_bench_feats(m, 64, 400 + i) for i in range(5)]
    eager = _eager(opt, cuda_device)
    want = [eager.dispatch(model, b) for b in batches]
    tr = get_translator(opt, device=cuda_device)
    got = [tr.dispatch(model, b) for b in batches]
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert len(g) == len(w) == 4
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and torch.equal(a, b)
    assert (tr.edge_passes, tr.graph_edge_passes) == (5, 4)
    lengths = {int(n) for out in want for n in out[2].flatten()}
    assert len(lengths) > 1, lengths               # the EOS clock's ends


@pytest.mark.gpu
def test_long_key_replays_with_early_stops_two_in_flight(cuda_device):
    """The long-key model through K4a, its captions ending early (the EOS
    clock), batches of 64, 64, 17 and 64 two in flight: equal to the eager
    loop bit for bit, K1's and K4a's launches too."""
    opt, model, m = _bench_model("msrvtt-care-swinbert", cuda_device,
                                 2**31 + 9, eos_clock=True)
    batches = [_bench_feats(m, n, 200 + i)
               for i, n in enumerate((64, 64, 17, 64))]
    want, want_n = _counted(_eager(opt, cuda_device), model, batches, 2)
    tr = get_translator(opt, device=cuda_device)
    got, got_n = _counted(tr, model, batches, 2)
    assert got == want
    assert got_n == want_n
    assert want_n[1] == want_n[2] * opt["num_hidden_layers_decoder"]
    assert want_n[2] < len(batches) * (opt["max_len"] - 1)  # early stops
    assert 0 < tr.graph_steps < want_n[2]
    assert (tr.edge_passes, tr.graph_edge_passes) == (4, 2)


@pytest.mark.gpu
def test_a_traced_replay_shows_k1(cuda_device):
    """A profiler opened after the capture records each replayed step's
    K1 kernel."""
    opt, model, m = _bench_model("msrvtt-care-vit", cuda_device, 2**31 + 5)
    batch = _bench_feats(m, 64, 7)
    tr = get_translator(opt, device=cuda_device)
    tr.translate_batch(model, batch)
    steps, replays = tr.beam_steps, tr.graph_steps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        tr.translate_batch(model, batch)
        torch.cuda.synchronize()
    assert tr.graph_steps - replays == tr.beam_steps - steps == 29
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("head_stats_tc_kernel" in n for n in names) == 29


def _graph_launches(events, span):
    """The device operations each ``cudaGraphLaunch`` inside the host
    range ``span`` launched, by launch."""
    cpu = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CPU]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns())
              for e in cpu if e.name() == span]
    launches = [e.correlation_id() for e in cpu
                if e.name().startswith("cudaGraphLaunch")
                and any(s <= e.start_ns() <= t for s, t in ranges)]
    ops = [e for e in events
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    return [[e.name() for e in ops if e.correlation_id() == c]
            for c in launches]


@pytest.mark.gpu
def test_a_traced_replay_launches_the_edges_in_their_spans(cuda_device):
    """A profiler opened after the capture: the front edge's kernels come
    from one graph launch inside ``care.encode`` (at least as many as the
    eager edge launches inside ``care.encode`` and ``care.beam.init``),
    the ranking's from one inside ``care.beam.final``, so their idle gaps
    stay in the batch edges' group."""
    opt, model, m = _bench_model("msrvtt-care-vit", cuda_device, 2**31 + 5)
    batch = _bench_feats(m, 64, 9)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def traced(tr):
        tr.translate_batch(model, batch)
        with torch.profiler.profile(activities=acts) as prof:
            tr.translate_batch(model, batch)
            torch.cuda.synchronize()
        return prof.profiler.kineto_results.events()

    eager = traced(_eager(opt, cuda_device))
    dev = [e for e in eager
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    cpu = [e for e in eager
           if e.device_type() == torch.autograd.DeviceType.CPU]
    ranges = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in cpu
              if e.name() in ("care.encode", "care.beam.init")]
    launched = {e.correlation_id() for e in cpu
                if e.name().startswith(("cudaLaunch", "cuLaunch"))
                and any(s <= e.start_ns() <= t for s, t in ranges)}
    eager_edge = sum(e.correlation_id() in launched for e in dev)
    tr = get_translator(opt, device=cuda_device)
    events = traced(tr)
    assert tr.graph_edge_passes == 1
    (edge,) = _graph_launches(events, "care.encode")
    (final,) = _graph_launches(events, "care.beam.final")
    assert eager_edge > 20
    assert sum(not n.startswith(("Memcpy", "Memset"))
               for n in edge) >= eager_edge
    assert any("gemm" in n.lower() for n in edge)
    assert len(final) > 5
    assert _graph_launches(events, "care.beam.init") == []


@pytest.mark.gpu
@pytest.mark.parametrize("eos_clock", [False, True], ids=["flagship", "eos"])
def test_replays_equal_the_eager_plain_loop_on_the_card(cuda_device,
                                                        monkeypatch,
                                                        eos_clock):
    """The flagship at full width, with captions that run to ``max_len``
    and with the EOS clock's: replays through the bookkeeping kernel give
    the tokens and scores of the eager loop on the plain torch ops, and
    one kernel launch a beam step."""
    opt, model, m = _bench_model("msrvtt-care-vit", cuda_device, 2**31 + 13,
                                 eos_clock=eos_clock)
    batches = [_bench_feats(m, 64, 300 + i) for i in range(3)]
    search = sys.modules["care_tpu_torch.decoding.beam_search"]
    monkeypatch.setattr(search, "beam_bookkeeping",
                        bb.beam_bookkeeping_plain)
    launches = bb.launches
    want, want_n = _counted(_eager(opt, cuda_device), model, batches, 1)
    assert bb.launches == launches
    monkeypatch.undo()
    tr = get_translator(opt, device=cuda_device)
    got, got_n = _counted(tr, model, batches, 1)
    assert got == want
    assert got_n == want_n
    assert bb.launches - launches == tr.beam_steps
    assert tr.graph_steps > 0
    if eos_clock:
        assert tr.beam_steps < len(batches) * (opt["max_len"] - 1)
