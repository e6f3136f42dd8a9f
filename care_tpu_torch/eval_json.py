"""Score a saved predictions JSON against references.

Port of ``eval_json.py`` (reference ``eval_json.py:9-27``):

    python -m care_tpu_torch.eval_json -json preds.json -ref refs.pkl

prints each COCO score as ``name: value``. Scoring runs on the host.
"""

import argparse
import json
import pickle


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("-json", "--json_path", type=str, required=True)
    p.add_argument("-ref", "--reference", type=str, required=True)
    return p.parse_args(argv)


def main(argv=None) -> dict:
    from care_tpu_torch.metrics import COCOScorer

    args = parse_args(argv)
    with open(args.json_path) as f:
        preds = json.load(f)
    with open(args.reference, "rb") as f:
        refs = pickle.load(f)

    # accept either {vid: [{'caption': ...}]} or {vid: 'caption'}
    preds = {k: (v if isinstance(v, list) else [{"caption": v}])
             for k, v in preds.items()}
    scores, _ = COCOScorer().score(refs, preds, list(preds.keys()))
    for k, v in scores.items():
        print(f"{k}: {v:.4f}")
    return scores


if __name__ == "__main__":
    main()
