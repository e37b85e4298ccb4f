"""ctypes loader for the native runtime library (native/src/).

The TPU compute path is JAX/XLA/Pallas; the host-side runtime around it
(DOF-graph entity numbering, data import nearest-point search, Exodus
big-endian decode) has C++ implementations, mirroring the reference's
native runtime (Panzer DOFManager graph build, data.cpp importer).

The shared library builds on first use with the baked-in g++ and is
cached under native/build/. Every entry point has a numpy fallback, so
the framework works without a toolchain; `available()` reports which
path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_ROOT, "native", "src", "mrhyde_native.cpp")
_SO = os.path.join(_ROOT, "native", "build", "libmrhyde_native.so")

_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    cmd = ["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
           _SRC, "-o", _SO]
    try:
        subprocess.run(cmd, check=True, capture_output=True,
                       timeout=120)
        return True
    except (OSError, subprocess.SubprocessError):
        return False


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("MRHYDE_NO_NATIVE"):
            return None
        if (not os.path.exists(_SO)
                or os.path.getmtime(_SO) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        i64 = ctypes.c_int64
        p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C")
        p_u64 = np.ctypeslib.ndpointer(np.uint64, flags="C")
        p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C")
        lib.unique_u64.restype = i64
        lib.unique_u64.argtypes = [p_u64, i64, p_i64, p_u64]
        lib.unique_pairs.restype = i64
        lib.unique_pairs.argtypes = [p_i64, i64, p_i64, p_i64]
        lib.unique_rows4.restype = i64
        lib.unique_rows4.argtypes = [p_i64, i64, p_i64, p_i64]
        lib.nearest_point.restype = None
        lib.nearest_point.argtypes = [p_f64, i64, p_f64, i64, i64,
                                      p_i64]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def unique_rows(rows: np.ndarray):
    """np.unique(rows, axis=0, return_inverse=True) for int rows with
    2 or 4 columns (entity numbering); native sort when available."""
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    n, w = rows.shape
    lib = _load()
    if lib is not None and w in (2, 4) and n > 0:
        inv = np.empty(n, dtype=np.int64)
        uniq = np.empty_like(rows)
        if w == 2:
            nu = lib.unique_pairs(rows, n, inv, uniq)
        else:
            nu = lib.unique_rows4(rows, n, inv, uniq)
        return uniq[:nu], inv
    uniq, inv = np.unique(rows, axis=0, return_inverse=True)
    return uniq, inv


def nearest_point(points: np.ndarray, queries: np.ndarray):
    """(Q,) index of the closest point for each query row."""
    points = np.ascontiguousarray(points, dtype=np.float64)
    queries = np.ascontiguousarray(queries, dtype=np.float64)
    lib = _load()
    if lib is not None and points.shape[0] and queries.shape[0]:
        out = np.zeros(queries.shape[0], dtype=np.int64)
        lib.nearest_point(points, points.shape[0], queries,
                          queries.shape[0], points.shape[1], out)
        return out
    d2 = ((queries[:, None, :] - points[None, :, :]) ** 2).sum(-1)
    return np.argmin(d2, axis=1)
