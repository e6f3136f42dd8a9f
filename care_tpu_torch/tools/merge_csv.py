"""Aggregate seed-replicated results: mean (std), scores x100, 1 decimal.

The port's copy of ``misc_tools/merge_csv.py`` (reference
``misc/merge_csv.py:37-111``): globs
``<base>/<dataset>/<method>/<task>/<scope>/test_result.csv`` (the CSVs
that ``python -m care_tpu_torch.train`` and ``translate --save_csv`` write
next to a run's checkpoints) and reports each run's mean and standard
deviation across its seed rows::

    python -m care_tpu_torch.tools.merge_csv -base ./exps -d MSRVTT
"""

import argparse
import glob
import os

METRICS = ["Bleu_1", "Bleu_2", "Bleu_3", "Bleu_4", "METEOR", "ROUGE_L",
           "CIDEr", "Sum"]


def merge(base: str, dataset: str, method: str = "*", task: str = "*",
          scope: str = "*", csv_name: str = "test_result.csv"):
    """One row a run: method, task, scope, each metric's
    ``"mean (std)"`` x100 (population std) and ``n_seeds``."""
    import pandas as pd
    pattern = os.path.join(base, dataset, method, task, scope, csv_name)
    rows = []
    for path in sorted(glob.glob(pattern)):
        df = pd.read_csv(path)
        rel = os.path.relpath(path, os.path.join(base, dataset))
        parts = rel.split(os.sep)
        entry = {"method": parts[0], "task": parts[1],
                 "scope": parts[2] if len(parts) > 3 else ""}
        for m in METRICS:
            if m in df.columns:
                vals = df[m].astype(float) * 100
                entry[m] = f"{vals.mean():.1f} ({vals.std(ddof=0):.1f})"
        entry["n_seeds"] = len(df)
        rows.append(entry)
    return pd.DataFrame(rows)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-base", type=str, default="./exps")
    p.add_argument("-d", "--dataset", type=str, default="MSRVTT")
    p.add_argument("-method", type=str, default="*")
    p.add_argument("-task", type=str, default="*")
    p.add_argument("-scope", type=str, default="*")
    args = p.parse_args(argv)
    out = merge(args.base, args.dataset, args.method, args.task, args.scope)
    print(out.to_string(index=False))
    return out


if __name__ == "__main__":
    main()
