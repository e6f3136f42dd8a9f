"""Every part of a cell sits in a file of its own, which the harness finds
by the name that ``BENCHMARK.json``, a configuration or a mix gives it:

* ``drivers/<mix["driver"]>.py``: the loop the window runs (its ``Driver``);
* ``generators/<mix["generator"]>.py``: the inputs, from the seed (``make``);
* ``weights/<configuration["weights"]>.py``: the weights, from the seed
  (``make``);
* ``judges/<configuration["judge"]>.py``: everything that depends on the
  kind of model (see below);
* ``metrics/<name>.py``: a metric's reader (``read``), else the reader of
  the name's part before its first dot.

A judge holds:

* ``param_shapes(model)``: parameter name -> shape of the plain reference,
  which are the state-dict names of the program's model; the weights maker
  draws these and both sides load them;
* ``precision(name)``: a context in which the reference computes in
  ``name`` (``"f32"``, or the control's lower precision);
* the readings its drivers ask for once the window has closed (the CARE
  judge's ``serve_readings``: the comparisons that decide ``correct``, and
  with ``control`` the control's readings beside them);
* ``check_forward(cfg, seed)``: at test size on the CPU (``cfg`` as the
  tests cut it), the plain reference against the program on the same
  weights drawn from ``seed``; raises on a mismatch;
* ``FAULTS``: fault name -> ``plant(driver, setattr)``, which plants the
  fault in the program's path under a run (``setattr`` is the tests'
  ``monkeypatch.setattr``), and which the judge's comparison must catch.
  Every configuration's judge has at least one.

A later cell adds its files and manifest entries; no file here changes. A
configuration of a new kind brings a judge of its own.
"""

import importlib
import importlib.util
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def module(kind: str, name: str):
    """``portbench/<kind>/<name>.py``, imported."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.exists(path):
        raise SystemExit(f"portbench: no {kind}/{name}.py")
    if "." not in name:
        return importlib.import_module(f"portbench.{kind}.{name}")
    spec = importlib.util.spec_from_file_location(
        f"portbench.{kind}.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric_name: str):
    """The reader of a metric: ``metrics/<name>.py``, else the reader of
    the name's part before its first dot."""
    for stem in (metric_name, metric_name.split(".")[0]):
        if os.path.exists(os.path.join(HERE, "metrics", stem + ".py")):
            return module("metrics", stem).read
    raise SystemExit(f"portbench: no reader for metric {metric_name!r}")
