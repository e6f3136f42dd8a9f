"""Chip smoke test of the PyTorch/CUDA port (``care_tpu_torch``) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits nonzero
before the last line:

1. device: the card's name, ``nvidia-smi``'s name and power limit, the
   torch and CUDA versions. Fails at once without a CUDA device.
2. build: every kernel of the serving path is compiled with ``nvcc`` from
   ``care_tpu_torch/csrc`` (all sources at once), printing the build seconds
   and the ``-Xptxas -v`` register and shared-memory summary.
3. check: each kernel against its plain PyTorch version on the card, at the
   shapes the flagship's serving path gives it and in the tie, bf16 and
   ragged-row cases.
4. serve: the full-width CARE flagship (MSRVTT, Transformer, CARE, ViT,
   VA/VAT; random weights from a seed) captions 3 batches of 64 synthetic
   videos and one ragged batch of 17 through
   ``get_translator(opt).translate_batch``. The kernel launch counts must
   match the beam steps run, and every returned score must equal the
   teacher-forced score of its tokens from the full forward.
5. time: each kernel, its plain version and the unfused torch sequence,
   100 warm launches timed with CUDA events, beside the kernel's bound.

The line before the last is a JSON object with one entry per kernel; the
last line is the device JSON object.
"""

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

from care_tpu_torch import constants
from care_tpu_torch.config import get_opt
from care_tpu_torch.decoding import get_translator
from care_tpu_torch.models import build_captioner
from care_tpu_torch.ops import _build
from care_tpu_torch.ops import fused_head_topk as fht

SEED = 0
BATCH, RAGGED = 64, 17
# NVIDIA H100 SXM data-sheet peaks at 700 W: HBM3 bandwidth, and f32 on the
# CUDA cores (no tensor cores), the rate the f32 kernels run at
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

KERNELS = {
    "fused_head_topk": dict(
        route="cuda", source="care_tpu_torch/csrc/fused_head_topk.cu",
        replaces="care_tpu/ops/fused_head_topk.py:151"),
}


def flagship_opt() -> dict:
    """The flagship serving configuration at full width
    (``__graft_entry__.py:_flagship_opt``)."""
    opt = get_opt({"dataset": "MSRVTT", "method": "Transformer",
                   "task": "CARE", "feats": "ViT",
                   "decoder_modality_flags": "VA",
                   "predictor_modality_flags": "VAT", "vocab_size": 11000},
                  read_vocab=False, resolve_paths=False)
    opt["dim_a"], opt["dim_m"], opt["dim_i"], opt["dim_r"] = 128, 2048, 512, 512
    return opt


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this test runs on a GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(f"device: {name}; count {torch.cuda.device_count()}")
    print(f"nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    return name


def phase_build() -> None:
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        builds = dict(zip(KERNELS, pool.map(_build.build, KERNELS)))
    for name, info in builds.items():
        print(f"build {name}: {info['seconds']:.1f} s")
        for line in info["log"].splitlines():
            if "registers" in line or "Compiling entry" in line \
                    or "spill" in line:
                print(f"  {line.strip()}")


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

def _head_inputs(rows, H, V, dtype, exact, seed):
    """h [rows, H], W [V, H] on the card. ``exact`` draws small dyadic
    values whose products and sums are exact in f32, so any summation order
    gives bit-identical logits (and exact ties where columns repeat)."""
    g = torch.Generator().manual_seed(seed)
    if exact:
        h = torch.randint(-4, 5, (rows, H), generator=g).float() / 8
        W = torch.randint(-8, 9, (V, H), generator=g).float() / 64
    else:
        h = torch.randn((rows, H), generator=g)
        W = (torch.rand((V, H), generator=g) * 2 - 1) * (6 / (H + V)) ** 0.5
    return h.to("cuda", dtype), W.to("cuda", dtype)


def _check_head_case(label, h, W, K, ties_exact):
    got = fht._stats_cuda(h, W, None, K)
    want = fht._stats_plain(h, W, None, K + 1, 1024)
    torch.cuda.synchronize()
    cv, ids, m, s = (t.cpu() for t in got)
    pv, pi, pm, ps = (t.cpu() for t in want)
    err_m = (m - pm).abs().max().item()
    err_logs = (s.log() - ps.log()).abs().max().item()
    err_cv = (cv - pv[:, :K]).abs().max().item()
    assert torch.allclose(m, pm, rtol=1e-5, atol=1e-6), (label, err_m)
    assert torch.allclose(s.log(), ps.log(), rtol=1e-5, atol=1e-6), \
        (label, err_logs)
    assert err_cv <= 1e-4, (label, err_cv)
    ids = ids.long()
    if ties_exact:
        assert torch.equal(ids, pi[:, :K]), label
    else:
        # ids must agree wherever a candidate is separated from both its
        # neighbours in the ranking by more than the value tolerance
        gap_prev = torch.cat([torch.full((pv.shape[0], 1), float("inf")),
                              pv[:, :K - 1] - pv[:, 1:K]], dim=1)
        gap_next = pv[:, :K] - pv[:, 1:K + 1]
        sep = (gap_prev > 1e-4) & (gap_next > 1e-4)
        assert torch.equal(ids[sep], pi[:, :K][sep]), label
    print(f"check fused_head_topk {label}: rows {h.shape[0]} H {h.shape[1]} "
          f"V {W.shape[0]} K {K} {str(h.dtype)[6:]}: max|dm| {err_m:.2e} "
          f"max|dlog s| {err_logs:.2e} max|dcv| {err_cv:.2e} ids ok "
          f"(tolerance: m, log s 1e-5 relative; cv 1e-4; ids "
          f"{'all' if ties_exact else 'where separated by > 1e-4'})")
    return err_cv


def phase_check(opt) -> dict:
    K, H, V = opt["beam_size"], opt["dim_hidden"], opt["vocab_size"]
    rows = BATCH * K
    h, W = _head_inputs(rows, H, V, torch.float32, False, 1)
    err = _check_head_case("flagship", h, W, K, ties_exact=False)
    _check_head_case("ragged", *_head_inputs(RAGGED * K, H, V, torch.float32,
                                             False, 2), K, ties_exact=False)
    _check_head_case("bf16", *_head_inputs(rows, H, V, torch.bfloat16, True,
                                           3), K, ties_exact=True)
    h, W = _head_inputs(rows, H, V, torch.float32, True, 4)
    # every column repeats 37 columns later, across tile and chunk borders
    W = W[torch.arange(V, device="cuda") % 37].contiguous()
    _check_head_case("ties", h, W, K, ties_exact=True)
    return {"fused_head_topk": err}


# ---------------------------------------------------------------------------
# serving the flagship
# ---------------------------------------------------------------------------

def _synthetic_feats(opt, n, seed):
    rs = np.random.RandomState(seed)
    feats = []
    for char in opt["modality"]:
        length = opt["retrieval_topk"] if char == "r" else opt["n_frames"]
        feats.append(rs.randn(n, length, opt[f"dim_{char}"]).astype(np.float32))
    return feats


@torch.no_grad()
def _teacher_forced_scores(model, opt, feats, hyps):
    """Σ log p(token) / len**alpha of each hypothesis from the full forward.
    Filler after a hypothesis is EOS, not PAD: causal attention keeps the
    filler out of earlier positions, while a PAD input would be masked."""
    dev = next(model.parameters()).device
    tf = [torch.as_tensor(f, device=dev) for f in feats]
    inputs = model.prepare_inputs_for_decoder(model.encoding_phase(tf), {})
    L = max(len(h[0]) for h in hyps)
    ids = torch.full((len(hyps), L), constants.EOS, dtype=torch.long)
    ids[:, 0] = constants.BOS
    usable = []
    for n, h in enumerate(hyps):
        toks = h[0]
        ids[n, 1:len(toks)] = torch.as_tensor(toks[:-1])
        # a generated PAD token as decoder input is masked by the full
        # forward but not by the KV-cached step; such rows are not compared
        usable.append(constants.PAD not in toks[:-1])
    logp = torch.log_softmax(
        model.decoding_phase(ids.to(dev), inputs)["logits"].float(), dim=-1)
    scores = []
    for n, h in enumerate(hyps):
        toks = torch.as_tensor(h[0], device=dev)
        total = logp[n, torch.arange(len(toks), device=dev), toks].sum()
        scores.append(total.item() / len(toks) ** opt["beam_alpha"])
    return scores, usable


def phase_serve(opt) -> dict:
    t0 = time.perf_counter()
    model = build_captioner(opt, seed=SEED)
    translator = get_translator(opt)
    torch.cuda.synchronize()
    print(f"serve: built the flagship Captioner "
          f"({sum(p.numel() for p in model.parameters())} parameters) in "
          f"{time.perf_counter() - t0:.1f} s")
    batches = [_synthetic_feats(opt, BATCH, SEED + 10 + i) for i in range(3)]
    batches.append(_synthetic_feats(opt, RAGGED, SEED + 20))
    translator.translate_batch(model, {"feats": batches[0]})      # warm-up

    fht.launches = 0
    translator.beam_steps = 0
    results, seconds = [], []
    for feats in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        results.append(translator.translate_batch(model, {"feats": feats}))
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    counts = {"fused_head_topk": fht.launches}
    steps = translator.beam_steps
    assert steps > 0 and counts["fused_head_topk"] == steps, (counts, steps)

    worst, checked, total = 0.0, 0, 0
    for feats, (hyps, scores) in zip(batches, results):
        assert len(hyps) == feats[0].shape[0]
        assert all(len(h) == 1 and len(h[0]) >= 1 for h in hyps)
        assert all(np.isfinite(s[0]) for s in scores)
        ref, usable = _teacher_forced_scores(model, opt, feats, hyps)
        for s, r, ok in zip(scores, ref, usable):
            total += 1
            if ok:
                checked += 1
                worst = max(worst, abs(s[0] - r))
    assert worst <= 1e-3, worst
    assert checked >= total // 2, (checked, total)
    full = sum(seconds[:3])
    print(f"serve: {len(batches)} batches ({3 * BATCH} + {RAGGED} videos), "
          f"{steps} beam steps, fused_head_topk launches "
          f"{counts['fused_head_topk']}")
    print(f"serve: batch seconds {[round(s, 4) for s in seconds]}; "
          f"{3 * BATCH / full:.1f} caps/s at batch {BATCH}; "
          f"{1e3 * sum(seconds) / steps:.3f} ms per beam step")
    print(f"serve: scores re-checked by teacher forcing: {checked}/{total} "
          f"hypotheses, max |diff| {worst:.2e}")
    print(f"serve: first caption tokens {results[0][0][0][0][:12]}")
    _profile_batch(translator, model, batches[0], seconds[0])
    return counts


def _profile_batch(translator, model, feats, unprofiled_seconds):
    """One batch-64 decode again under torch.profiler: the device time by
    kernel, and the device's busy share of the same batch's unprofiled
    wall time (the profiler slows the host, not the device)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        translator.translate_batch(model, {"feats": feats})
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print("profile: the profiler saw no device time: not measured")
        return
    k1_us = sum(e.self_device_time_total for e in kernels
                if "tile_stats_kernel" in e.key or "merge_kernel" in e.key)
    print(f"profile: batch {feats[0].shape[0]}: device busy "
          f"{busy_us / 1e3:.3f} ms of {1e3 * unprofiled_seconds:.3f} ms wall "
          f"({100 * busy_us / 1e6 / unprofiled_seconds:.1f}% busy); "
          f"{sum(e.count for e in kernels)} device operations (kernels "
          f"and copies); "
          f"fused_head_topk {100 * k1_us / busy_us:.1f}% of device time")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"profile:   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:5d}x {e.key[:90]}")


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

def _time_ms(fn, n=100, warm=10):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def phase_time(opt, errors, counts) -> list:
    K, H, V = opt["beam_size"], opt["dim_hidden"], opt["vocab_size"]
    rows = BATCH * K
    h, W = _head_inputs(rows, H, V, torch.float32, False, 1)
    saved = fht.launches
    ms = _time_ms(lambda: fht._stats_cuda(h, W, None, K))
    plain_ms = _time_ms(lambda: fht._stats_plain(h, W, None, K, 1024))
    unfused_ms = _time_ms(
        lambda: torch.topk(torch.log_softmax(h @ W.t(), dim=-1), K))
    fht.launches = saved
    flops = 2 * rows * H * V
    n_bytes = 4 * (rows * H + V * H) + 4 * rows * (2 + 2 * K)
    t_ops, t_bytes = flops / PEAK_F32_FLOPS, n_bytes / PEAK_BYTES_PER_S
    entry = dict(
        name="fused_head_topk", **KERNELS["fused_head_topk"],
        launches=counts["fused_head_topk"],
        max_abs_err=errors["fused_head_topk"], ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None,
        # h @ W.T, log_softmax, topk: three calls, not one library call
        unfused_torch_ms=unfused_ms)
    print(f"time fused_head_topk at [{rows}, {H}] x [{V}, {H}] f32: "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, unfused torch "
          f"sequence (3 calls) {unfused_ms:.4f} ms, bound "
          f"{entry['bound_ms']:.4f} ms ({entry['bound_by']}: {flops} flop, "
          f"{n_bytes} bytes)")
    return [entry]


def main() -> None:
    name = phase_device()
    opt = flagship_opt()
    phase_build()
    errors = phase_check(opt)
    counts = phase_serve(opt)
    kernels = phase_time(opt, errors, counts)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
