"""The readings the limits of ``correct`` are set from, on the card at a
cell's own size. The benchmark's runs do not run this.

    python3 portbench/control.py --workload <name> --seeds 1,2,3 \
        [--seconds 3] [--out <file.jsonl>]

For each seed, in one process: the cell's set-up and a short window at its
own load, then the comparison with the plain reference (the program's
readings, the lower ends of the limits), and the control: the reference
computed in TF32 (the nearest precision below the configurations' f32 with
TF32 off) put in the program's place, on the same inputs and tokens. One
JSON line a seed.
"""

import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from portbench import lookup, run  # noqa: E402
from portbench.devtrace import Tracer  # noqa: E402


def readings(workload, seeds, seconds, device="cuda", cell=None):
    import torch
    bench, c, cfg, mix = cell or run.load_cell(workload)
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    for seed in seeds:
        t0 = time.perf_counter()
        driver = lookup.module("drivers", mix["driver"]).Driver(
            cfg, mix, seed, device)
        setup = time.perf_counter() - t0
        samples = driver.window(seconds, Tracer(False, device))
        driver.release()
        r, attempted, failed = driver.check(control="tf32")
        yield {"workload": c["name"], "seed": seed, "setup_s": setup,
               "window": {k: v for k, v in samples.items()
                          if not isinstance(v, list)},
               "attempted": attempted, "failed": failed, "readings": r}
        del driver
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--out")
    args = p.parse_args()
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    try:
        for line in readings(args.workload, seeds, args.seconds):
            text = json.dumps(line)
            print(text, flush=True)
            if out:
                out.write(text + "\n")
                out.flush()
    finally:
        if out:
            out.close()


if __name__ == "__main__":
    main()
