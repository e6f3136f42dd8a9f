"""ctypes binding for the native evaluation core (``libcare_eval.so``).

Port of ``care_tpu/native/__init__.py``. ``eval_core.cc`` is compiled on
first use with the host C++ compiler into ``care_tpu_torch/build/``, a
directory the repository does not track, and never next to its source. When
no compiler is found or the build fails, ``available()`` is False and the
scorers take their pure-Python paths. These are host routines, not device
kernels. Importing this module builds nothing.
"""

import ctypes
import os
import shutil
import subprocess

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "eval_core.cc")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "build")
LIB_PATH = os.path.join(BUILD_DIR, "libcare_eval.so")
CXX_FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lib = None
_tried = False


def _compiler():
    for name in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def _build() -> bool:
    """Compile the library unless it is newer than its source; True when an
    up-to-date library is there."""
    if (os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(_SRC)):
        return True
    cxx = _compiler()
    if cxx is None:
        return False
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        return False
    os.replace(tmp, LIB_PATH)
    return True


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    # never load a stale library: its ABI may not match the bindings
    if not _build():
        return None
    try:
        lib = ctypes.CDLL(LIB_PATH)
    except OSError:
        return None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.lcs_len.restype = ctypes.c_int32
    lib.lcs_len.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32]
    lib.meteor_align.restype = ctypes.c_int32
    lib.meteor_align.argtypes = [i32p, i32p, ctypes.c_int32, i32p, i32p,
                                 ctypes.c_int32, i32p]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _as_i32(seq):
    import numpy as np
    arr = np.ascontiguousarray(seq, dtype=np.int32)
    return arr, arr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def lcs_len(a, b):
    """Native LCS over two int sequences; None if the library is absent."""
    lib = _load()
    if lib is None:
        return None
    aa, pa = _as_i32(a)
    bb, pb = _as_i32(b)
    return int(lib.lcs_len(pa, len(aa), pb, len(bb)))


def meteor_align(hyp_exact, hyp_stem, ref_exact, ref_stem):
    """Native METEOR-1.5 beam-search alignment; returns [(h, r, module)]
    or None. Semantics match ``care_tpu_torch/metrics/meteor.py:_align``
    (joint beam resolution: max matches, then min chunks, then min distance;
    exact + stem modules). Returns None for refs > 64 tokens (bitmask
    width): callers fall back to the Python aligner."""
    import numpy as np
    lib = _load()
    if lib is None:
        return None
    he, phe = _as_i32(hyp_exact)
    hs, phs = _as_i32(hyp_stem)
    re_, pre = _as_i32(ref_exact)
    rs, prs = _as_i32(ref_stem)
    n_hyp, n_ref = len(he), len(re_)
    out = np.zeros(3 * max(n_hyp, 1), dtype=np.int32)
    m = lib.meteor_align(
        phe, phs, n_hyp, pre, prs, n_ref,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    if m < 0:
        return None
    return [(int(out[3 * k]), int(out[3 * k + 1]), int(out[3 * k + 2]))
            for k in range(m)]
