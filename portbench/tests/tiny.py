"""Tiny versions of the benchmark's configurations and mixes, for its
tests on the CPU: the same code paths at widths a test can hold."""

import copy
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

HERE = os.path.join(ROOT, "portbench")

TINY = {"dim_hidden": 32, "num_attention_heads": 4, "intermediate_size": 64,
        "max_len": 8, "attribute_prediction_k": 40, "use_attr_topk": 6,
        "n_frames": 4, "retrieval_topk": 3, "n_total_frames": 10,
        "batch_size": 4, "vocab_size": 300}


def _json(*parts):
    with open(os.path.join(HERE, *parts)) as f:
        return json.load(f)


def config(name: str) -> dict:
    """The configuration ``name`` at test widths."""
    cfg = copy.deepcopy(_json("configs", name + ".json"))
    cfg["get_opt"]["vocab_size"] = TINY["vocab_size"]
    dims = {"a": 8, "m": 16, "i": 12, "r": 12}
    cfg["set"] = dict(TINY, **{f"dim_{c}": d for c, d in dims.items()})
    cfg["set"].pop("vocab_size")
    m = cfg["model"]
    m.update({k: v for k, v in TINY.items() if k in m})
    m["dims"] = dims
    long_m = m["rows"]["m"]
    m["rows"] = {"a": 4, "m": long_m if long_m > 100 else 4, "i": 4, "r": 3}
    m["n_total_frames"] = TINY["n_total_frames"]
    m["cross_attention_keys"] = (8 + m["rows"]["m"] + TINY["use_attr_topk"])
    if "eos_clock" in m:
        m["eos_clock"] = dict(m["eos_clock"], words=TINY["max_len"] // 2)
    return cfg


def mix(name: str) -> dict:
    """The mix ``name`` at the sizes its ``test_size`` gives."""
    mx = copy.deepcopy(_json("traffic", name + ".json"))
    mx.update(mx.pop("test_size", {}))
    return mx


def bench() -> dict:
    return _json(os.pardir, "BENCHMARK.json")


def cell(workload: str) -> tuple:
    b = bench()
    c = {w["name"]: w for w in b["workloads"]}[workload]
    return b, c, config(c["config"]), mix(c["traffic"])


# every cell of the manifest, for the tests that run each
CELLS = [w["name"] for w in bench()["workloads"]]
