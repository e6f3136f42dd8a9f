"""``BENCHMARK.json`` against the benchmark's contract: names, units and
texts within the allowed characters and lengths, the keys each entry may
have, and a file for every configuration, mix, reader and limit it names."""

import json
import os
import re

import pytest

from tiny import HERE, ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level():
    b = bench()
    assert set(b) == TOP
    assert b["command"] == ["python3", "portbench/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len(json.dumps(b)) <= 64 * 1024


def test_configs():
    b = bench()
    used = {w["config"] for w in b["workloads"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _text(c["source"]) and _text(c["why"])
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])


def test_workloads():
    b = bench()
    names = [w["name"] for w in b["workloads"]]
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert os.path.exists(os.path.join(HERE, "traffic",
                                           w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "limits",
                                           w["name"] + ".json"))


def _reader_exists(name):
    return any(os.path.exists(os.path.join(HERE, "metrics", s + ".py"))
               for s in (name, name.split(".")[0]))


def test_metrics():
    b = bench()
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    names = list(e2e) + [m["name"] for m in b["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for w in m.get("workloads", []):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", [w])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and _reader_exists(m["name"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_enough():
    from portbench import run
    b = bench()
    for w in b["workloads"]:
        e2e = [m["name"] for m in run.metrics_for(b, w, False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert run.metrics_for(b, w, True), w["name"]


def test_four_chip_cells_within_share():
    b = bench()
    four = sum(w["chips"] == 4 for w in b["workloads"])
    assert four <= max(1, len(b["workloads"]) // 4)


@pytest.mark.parametrize("kind", ["configs", "traffic", "limits"])
def test_data_files_parse(kind):
    for name in os.listdir(os.path.join(HERE, kind)):
        with open(os.path.join(HERE, kind, name)) as f:
            assert isinstance(json.load(f), dict), name
