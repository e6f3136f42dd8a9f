"""The flagship's f32 serve of two checkouts, timed in turns in one process.

A change on the host side of the decode (the Python work around each beam
step's launches) shows only in wall time, whose swings between processes
and calls exceed such a change. This script loads the port twice into one
process, from ``DIR`` (another checkout of the repository, for example a
parent commit's ``care_tpu_torch/`` unpacked with ``git archive``) and from
this checkout, and serves the same batch through each in the order base,
new, new, base, round after round::

    python3 -m care_tpu_torch.tools.serve_ab --against DIR [--rounds 20]

Each copy builds the flagship at full width from the same seed (random
weights) and serves one batch of 64 videos at beam 5 through its own
``get_translator(opt).translate_batch`` (features already on the card, so
that no copy is timed), each batch closed by a synchronisation. A copy's
objects keep the module globals of the files they were built from, and no
module on the serve path imports anything at call time, so the two copies
do not mix. It prints the card and its power limit, the median wall ms per
batch of each copy, their ratio, and the median over the rounds of each
round's new - base difference.
"""

import argparse
import importlib
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

_PACKAGE = "care_tpu_torch"
BATCH = 64
_HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _load(tree: str):
    """The port's config, decoding and models packages imported from
    ``tree``, after every module of the package loaded before is dropped
    from ``sys.modules``."""
    for name in [m for m in sys.modules
                 if m == _PACKAGE or m.startswith(_PACKAGE + ".")]:
        del sys.modules[name]
    sys.path.insert(0, tree)
    try:
        mods = [importlib.import_module(f"{_PACKAGE}.{m}")
                for m in ("config", "decoding", "models")]
    finally:
        sys.path.remove(tree)
    assert all(m.__file__.startswith(tree) for m in mods), mods
    return mods


def _server(tree: str, device: str):
    """(translator, model, batch) of the flagship served from ``tree``."""
    config, decoding, models = _load(tree)
    opt = config.get_opt(
        {"dataset": "MSRVTT", "method": "Transformer", "task": "CARE",
         "feats": "ViT", "decoder_modality_flags": "VA",
         "predictor_modality_flags": "VAT", "vocab_size": 11000},
        read_vocab=False, resolve_paths=False)
    opt.update(dim_a=128, dim_m=2048, dim_i=512, dim_r=512)
    model = models.build_captioner(opt, device=device, seed=0)
    translator = decoding.get_translator(opt, device)
    rs = np.random.RandomState(10)
    feats = [torch.as_tensor(rs.randn(
        BATCH, opt["retrieval_topk"] if c == "r" else opt["n_frames"],
        opt["dim_" + c]).astype(np.float32), device=device)
        for c in opt["modality"]]
    return translator, model, {"feats": feats}


def _sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--against", required=True, metavar="DIR",
                   help="the other checkout (the base of the comparison)")
    p.add_argument("--rounds", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    if args.device == "cuda":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True).stdout
        print(f"serve_ab: card {card.strip()}")
    servers = {"base": _server(os.path.abspath(args.against), args.device),
               "new": _server(_HERE, args.device)}
    for translator, model, batch in servers.values():
        for _ in range(3):
            translator.translate_batch(model, batch)
    _sync(args.device)

    wall = {"base": [], "new": []}
    steps = {}
    for _ in range(args.rounds):
        for which in ("base", "new", "new", "base"):
            translator, model, batch = servers[which]
            translator.beam_steps = 0
            t0 = time.perf_counter()
            translator.translate_batch(model, batch)
            _sync(args.device)
            wall[which].append(1e3 * (time.perf_counter() - t0))
            steps[which] = translator.beam_steps
    assert steps["base"] == steps["new"] > 0, steps
    med = {k: statistics.median(v) for k, v in wall.items()}
    for which in ("base", "new"):
        print(f"serve_ab: {which}: median {med[which]:.3f} ms wall "
              f"({med[which] / steps[which]:.4f} ms per beam step, "
              f"{steps[which]} steps) a batch of {BATCH}; wall "
              f"{[round(m, 2) for m in wall[which]]}")
    diff = [(wall["new"][2 * r] + wall["new"][2 * r + 1]
             - wall["base"][2 * r] - wall["base"][2 * r + 1]) / 2
            for r in range(args.rounds)]
    result = {"base_ms": med["base"], "new_ms": med["new"],
              "ratio": med["new"] / med["base"],
              "round_diff_ms": statistics.median(diff)}
    print(f"serve_ab: new / base {result['ratio']:.4f}; median round "
          f"difference new - base {result['round_diff_ms']:.3f} ms per batch "
          f"over {args.rounds} rounds")
    return result


if __name__ == "__main__":
    main()
