"""A configuration of a new kind is added by files and manifest entries
alone: in a copy of the harness, a configuration whose judge is a file of
its own (the CARE judge's readings, a forward check of its own that
records that it ran, and a fault of its own: a wrong score returned by the
translator's ``collect``, which the CARE judge's faults do not plant),
with a cell and its limits. The harness's forward, fault and judge tests,
run in the copy, collect the new configuration's and cell's cases and pass
them, and no file of the copy but ``BENCHMARK.json`` is edited."""

import json
import os
import re
import shutil
import subprocess
import sys

from test_portbench_extend import _tree
from tiny import HERE, ROOT

CONFIG, CELL = "other-kind", "other.kind.serve"

JUDGE = '''
import os

from portbench.judges import care
from portbench.judges.care import (param_shapes, precision,  # noqa: F401
                                   serve_readings)


def check_forward(cfg, seed):
    with open(os.environ["KIND_CHECK_LOG"], "a") as f:
        f.write(cfg["name"] + "\\n")
    care.check_forward(cfg, seed)


def _wrong_score(driver, setattr):
    cls = type(driver.translator)
    collect = cls.collect

    def wrong(self, out):
        hyps, scores = collect(self, out)
        return hyps, [[s + 0.5 for s in row] for row in scores]
    setattr(cls, "collect", wrong)


FAULTS = {"wrong_score": _wrong_score}
'''

TESTS = ["portbench/tests/test_portbench_reference.py::"
         "test_forward_matches_program",
         "portbench/tests/test_portbench_faults.py",
         "portbench/tests/test_portbench_judges.py"]
EXPECTED = {f"test_forward_matches_program[{CONFIG}]",
            f"test_serving_faults_fail[{CELL}-wrong_score]",
            f"test_judge_has_its_duties[{CONFIG}]"}


def _add_kind(copy):
    pb = os.path.join(copy, "portbench")
    with open(os.path.join(pb, "judges", "other_kind.py"), "w") as f:
        f.write(JUDGE)
    with open(os.path.join(pb, "configs", "msrvtt-care-vit.json")) as f:
        cfg = json.load(f)
    cfg.update(name=CONFIG, judge="other_kind")
    with open(os.path.join(pb, "configs", CONFIG + ".json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "limits", CELL + ".json"), "w") as f:
        json.dump({"score_gap": 1e-4, "rank_gap": 1e-4}, f)
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"].append({"name": CONFIG, "source": cfg["source"],
                             "file": f"portbench/configs/{CONFIG}.json",
                             "reduced": [], "why": "a judge of its own"})
    bench["workloads"].append({"name": CELL, "config": CONFIG,
                               "traffic": "serve.b64", "chips": 1,
                               "why": "a configuration of a new kind"})
    for m in bench["end_to_end"]:
        if m["name"] == "caps_per_s":
            m["workloads"].append(CELL)
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)


def test_a_kind_added_by_files_alone(tmp_path):
    copy = str(tmp_path / "repo")
    shutil.copytree(HERE, os.path.join(copy, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("BENCHMARK.json", "pytest.ini"):
        shutil.copy(os.path.join(ROOT, name), copy)
    before = _tree(copy)
    _add_kind(copy)
    added = _tree(copy)
    assert [p for p in before if before[p] != added[p]] == ["BENCHMARK.json"]
    assert len(added) == len(before) + 3
    log = tmp_path / "check_forward.log"
    env = dict(os.environ, PYTHONPATH=ROOT, PYTHONDONTWRITEBYTECODE="1",
               KIND_CHECK_LOG=str(log))
    out = subprocess.run([sys.executable, "-m", "pytest", "-q", "-rA",
                          "-p", "no:cacheprovider", "-k", "other"] + TESTS,
                         capture_output=True, text=True, cwd=copy, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    passed = set(re.findall(r"^PASSED \S+::(\S+)", out.stdout, re.M))
    assert passed == EXPECTED, out.stdout[-3000:]
    assert log.read_text() == CONFIG + "\n"
    # the run edited nothing in the copy
    assert _tree(copy) == added
