"""A cell is added by files and manifest entries alone: in a copy of the
harness, a new generator, driver, weights maker, judge and metric reader,
each a new file named by a new mix, configuration and manifest entry, run
at test size on the CPU with no file of the copy edited."""

import json
import os
import shutil
import subprocess
import sys

from tiny import HERE, ROOT

FILES = {
    # a generator that reads the general one's parameters
    "generators/video_batches_reversed.py": '''
from portbench.generators import video_batches
from portbench.generators.video_batches import order  # noqa: F401


def make(m, mix, seed, device):
    return video_batches.make(m, mix, seed, device)[::-1]
''',
    # a driver that counts what it issued
    "drivers/serve_counted.py": '''
from portbench.drivers import serve


class Driver(serve.Driver):
    def window(self, seconds, tracer):
        out = super().window(seconds, tracer)
        out["issued_twice"] = 2 * out["batches"]
        return out
''',
    "weights/xavier_normal_copy.py": '''
from portbench.weights import xavier_normal


def make(shapes, seed, device, model=None):
    return xavier_normal.make(shapes, seed, device, model)
''',
    "judges/care_copy.py": '''
from portbench.judges.care import *  # noqa: F401,F403
from portbench.judges.care import param_shapes, precision  # noqa: F401
''',
    "metrics/issued_twice.py": '''
def read(ctx):
    return ctx.samples["issued_twice"]
''',
}

SCRIPT = r"""
import json, sys, time
sys.path[:0] = [{copy!r}, {copy!r} + "/portbench/tests", {root!r}]
import tiny
from portbench import run
b, c, cfg, mx = tiny.cell("added.serve")
out = run.run_cell(b, c, cfg, mx, 2**31 + 21, 0.5, True, "cpu",
                   t_start=time.perf_counter())
print(json.dumps({{"correct": out["correct"], "metrics": out["metrics"]}}))
"""


def _tree(top):
    out = {}
    for dp, _, fs in os.walk(top):
        for name in fs:
            path = os.path.join(dp, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, top)] = f.read()
    return out


def test_a_cell_added_by_files_alone(tmp_path):
    copy = str(tmp_path / "repo")
    shutil.copytree(HERE, os.path.join(copy, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy)
    before = _tree(copy)
    for rel, text in FILES.items():
        with open(os.path.join(copy, "portbench", rel), "w") as f:
            f.write(text)
    pb = os.path.join(copy, "portbench")
    with open(os.path.join(pb, "traffic", "serve.b64.json")) as f:
        mix = json.load(f)
    mix.update(driver="serve_counted", generator="video_batches_reversed")
    with open(os.path.join(pb, "traffic", "serve.added.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(pb, "configs", "msrvtt-care-vit.json")) as f:
        cfg = json.load(f)
    cfg.update(name="added-config", judge="care_copy",
               weights="xavier_normal_copy")
    with open(os.path.join(pb, "configs", "added-config.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, "limits", "added.serve.json"), "w") as f:
        json.dump({"score_gap": 1e-4, "rank_gap": 1e-4}, f)
    with open(os.path.join(copy, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["workloads"].append({"name": "added.serve",
                               "config": "added-config",
                               "traffic": "serve.added", "chips": 1,
                               "why": "added by files"})
    bench["per_layer"].append({"name": "issued_twice", "unit": "batches",
                               "better": "higher", "source": "host_clock",
                               "layer": "serving entry",
                               "moves": "caps_per_s",
                               "workloads": ["added.serve"]})
    for m in bench["end_to_end"]:
        if m["name"] == "caps_per_s":
            m["workloads"].append("added.serve")
    with open(os.path.join(copy, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    # nothing that was there changed but the manifest
    after = _tree(copy)
    assert [p for p in before if before[p] != after[p]] == ["BENCHMARK.json"]
    assert len(after) == len(before) + len(FILES) + 3
    out = subprocess.run([sys.executable, "-c",
                          SCRIPT.format(copy=copy, root=ROOT)],
                         capture_output=True, text=True, cwd=copy,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], line
    assert set(line["metrics"]) == {"issued_twice"}
    assert line["metrics"]["issued_twice"]["value"] > 0
