"""Retrieval-database robustness sweep: the port's form of
``scripts/retrieval_db_ratio.sh`` (reference
``scripts/retrieval_db_ratio.sh``).

Re-scores the five seed checkpoints of a PointerGen / retrieval run
(``best.ckpt``, ``best-v1.ckpt`` ... ``best-v4.ckpt`` under ``exp_path``)
while the retrieval database shrinks to 0.1%, 1% and 10% of its size;
``care_tpu_torch.translate --save_csv`` accumulates the rows into
``retrieval_db_ratio_<ratio>.csv`` next to each checkpoint, and
``care_tpu_torch.analysis`` aggregates them::

    python -m care_tpu_torch.tools.retrieval_db_ratio EXP_PATH \\
        [--device cpu] [--dry-run]

``--device`` is handed to ``translate`` (default: the CUDA card);
``--dry-run`` prints the commands without running them. The exit code is
1 when a command failed.
"""

import argparse
import os
import subprocess
import sys
from typing import List

RATIOS = ("0.1", "1", "10")
CHECKPOINTS = ("best.ckpt", "best-v1.ckpt", "best-v2.ckpt", "best-v3.ckpt",
               "best-v4.ckpt")


def commands(exp_path: str, device: str = None) -> List[List[str]]:
    """The 15 translate commands, ratio by ratio, checkpoint by
    checkpoint."""
    out = []
    for ratio in RATIOS:
        for name in CHECKPOINTS:
            cmd = [sys.executable, "-m", "care_tpu_torch.translate", "-cp",
                   os.path.join(exp_path, name), "--retrieval_db_ratio",
                   ratio, "--save_csv", "--csv_name",
                   f"retrieval_db_ratio_{ratio}.csv", "--mode", "test"]
            if device:
                cmd += ["--device", device]
            out.append(cmd)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("exp_path")
    p.add_argument("--device", type=str, default=None)
    p.add_argument("--dry-run", action="store_true")
    args = p.parse_args(argv)
    ratio, failed = None, 0
    for cmd in commands(args.exp_path, args.device):
        r = cmd[cmd.index("--retrieval_db_ratio") + 1]
        if r != ratio:
            ratio = r
            print(f"retrieval_db_ratio={ratio}")
        print("cmd: " + " ".join(cmd), flush=True)
        # as the shell script, a failed checkpoint does not stop the sweep
        if not args.dry_run:
            failed += subprocess.run(cmd).returncode != 0
    return int(failed > 0)


if __name__ == "__main__":
    sys.exit(main())
