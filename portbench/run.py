"""Run one cell of the benchmark of ``care_tpu_torch`` once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell (``BENCHMARK.json``'s ``workloads``) names a configuration
(``portbench/configs/<config>.json``) and a traffic mix
(``portbench/traffic/<traffic>.json``); the mix names its driver and its
generator, and the configuration its weights and its judge, each a file
that ``lookup.py`` finds by that name. The run makes the inputs and the
weights from the seed, builds the program and warms the cell's shapes
(set-up), measures for ``--seconds`` (with ``--trace 1`` a second window
follows under the profiler, for at most ``TRACE_SECONDS``), frees the
program, holds what the window produced against the plain reference, and
prints one JSON line. Each metric is read by its reader
(``lookup.reader``); a reader that finds nothing to read returns None and
the metric is left out. Without a CUDA card, or with fewer than the cell
asks for, it exits with 2 and prints no result; a run whose process holds
a module of JAX or of the JAX package once the window has closed exits
with 3.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TRACE_SECONDS = 8.0
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "care_tpu")


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_cell(workload: str, bench_path: str = None) -> tuple:
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"portbench: no workload {workload!r} in "
                         f"BENCHMARK.json ({sorted(cells)})")
    cell = cells[workload]
    cfg = _json(os.path.join(HERE, "configs", cell["config"] + ".json"))
    mix = _json(os.path.join(HERE, "traffic", cell["traffic"] + ".json"))
    return bench, cell, cfg, mix


def metrics_for(bench: dict, cell: dict, trace: bool) -> list:
    """The metrics this cell reports: its end-to-end ones, or with a trace
    its per-layer ones."""
    name = cell["name"]
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (name in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def limits_for(workload: str) -> dict:
    path = os.path.join(HERE, "limits", workload + ".json")
    return _json(path) if os.path.exists(path) else {}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def run_cell(bench, cell, cfg, mix, seed, seconds, trace, device,
             t_start=None, limits=None, patch=None) -> dict:
    """Set-up, window, check and metrics of one run; returns the result
    line's fields. ``patch`` (tests): a callable given the driver before
    its window."""
    import torch
    from portbench import lookup, program
    from portbench.devtrace import Tracer
    t_start = T_START if t_start is None else t_start
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    driver = lookup.module("drivers", mix["driver"]).Driver(cfg, mix, seed,
                                                            device)
    if patch is not None:
        patch(driver)
    setup_s = time.perf_counter() - t_start
    before = driver.counters
    samples = driver.window(seconds, Tracer(False, device))
    counts = program.delta(driver.counters, before)
    tracer = Tracer(trace, device)
    trace_samples, trace_counts = None, None
    if trace:
        # a second window, under the profiler, for the device's numbers;
        # the host-clock ones come from the first, as untraced runs read
        before = driver.counters
        trace_samples = driver.window(min(seconds, TRACE_SECONDS), tracer)
        trace_counts = program.delta(driver.counters, before)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    summary = tracer.summary()
    driver.release()
    readings, attempted, failed = driver.check()
    limits = limits_for(cell["name"]) if limits is None else limits
    # every limit needs its reading, and every reading its limit
    checks = {k: {"value": _finite(readings.get(k)), "limit": limits.get(k)}
              for k in list(limits) + [k for k in readings
                                       if k not in limits]}
    correct = (failed == 0 and bool(checks) and all(
        c["limit"] is not None and c["value"] is not None
        and c["value"] <= c["limit"] for c in checks.values()))
    ctx = types.SimpleNamespace(
        model=cfg["model"], mix=mix, samples=samples, counts=counts,
        shapes=driver.shapes, setup_s=setup_s, window_s=samples["window_s"],
        trace=summary, trace_samples=trace_samples, trace_counts=trace_counts)
    metrics = {}
    for m in metrics_for(bench, cell, trace):
        value = lookup.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell["chips"], "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary.busy_s()
        device_info["window_s"] = summary.window_s
        out["breakdown"] = {"device_ops": summary.top_ops(),
                            "idle_gaps": summary.idle_gaps()}
    before_cell = setup_s - sum(driver.setup_parts.values())
    out["setup_parts_s"] = dict(driver.setup_parts,
                                 **{"before the cell's set-up": before_cell})
    out["counts"] = counts
    out["windows"] = [{k: v for k, v in w.items() if not isinstance(v, list)}
                      for w in (samples, trace_samples) if w is not None]
    if summary is not None:
        out["windows"][-1]["trace_reduce_s"] = summary.reduce_seconds
    out["checks"] = checks
    return out


def _finite(x):
    """A reading as JSON can carry it: None for none, or for NaN and
    infinities (which fail every limit)."""
    return x if x is None or math.isfinite(x) else None


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    bench, cell, cfg, mix = load_cell(args.workload)
    # the host loops are bound by one thread's launches: one intra-op
    # thread keeps idle OpenMP workers from competing with it for cores,
    # which made runs faster and steadier (PERF.md, section 2)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    import torch
    torch.set_num_threads(1)
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if cards < cell["chips"]:
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA "
              f"card(s); this machine has {cards}: nothing measured",
              file=sys.stderr)
        sys.exit(2)
    card = power_limit()
    out = run_cell(bench, cell, cfg, mix, args.seed, args.seconds,
                   bool(args.trace), "cuda")
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}, which the benchmark of "
              f"the port may not load", file=sys.stderr)
        sys.exit(3)
    checks = out.pop("checks")
    out["card"] = card
    out["checks"] = checks
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {out['correct']}", file=sys.stderr)
    sys.stdout.flush()
    sys.stderr.flush()
    print(json.dumps(out))


if __name__ == "__main__":
    main()
