"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on first use
with ``nvcc`` for Hopper (``sm_90a``) into ``care_tpu_torch/build/``, a
directory the repository does not track, then loaded with ``ctypes``. A
library is rebuilt when its source, or any shared header ``csrc/*.cuh``, is
newer. A failed build raises with the
compiler's output. Importing this module builds nothing.
"""

import ctypes
import glob
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_loaded = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels of care_tpu_torch "
                       "are built on a machine with the CUDA toolkit")


def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` into ``build/lib<name>.so`` unless it is
    up to date. Returns {"path", "seconds", "log"}: the build's wall time
    (0 when nothing was built) and the compiler's output, which holds the
    ``-Xptxas -v`` register and shared-memory summary."""
    src = os.path.join(CSRC_DIR, name + ".cu")
    lib = os.path.join(BUILD_DIR, f"lib{name}.so")
    log_path = lib + ".log"
    newest = max(map(os.path.getmtime,
                     [src, *glob.glob(os.path.join(CSRC_DIR, "*.cuh"))]))
    if (os.path.exists(lib) and os.path.exists(log_path)
            and os.path.getmtime(lib) >= newest):
        with open(log_path) as f:
            return {"path": lib, "seconds": 0.0, "log": f.read()}
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, src]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"building {src} failed ({' '.join(cmd)}):\n{log}")
    os.replace(tmp, lib)
    with open(log_path, "w") as f:
        f.write(log)
    return {"path": lib, "seconds": seconds, "log": log}


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use and loaded once per
    process."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(build(name)["path"])
    return _loaded[name]
