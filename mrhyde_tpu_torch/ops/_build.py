"""Build and bind the port's CUDA kernels.

`nvcc` compiles every `csrc/*.cu` of the package into one shared
library with a plain C interface, at first use, into `ops/build/`
(listed in .gitignore); ctypes binds it. Pointers and the stream are
passed as `c_void_p`, and every entry point returns the
`cudaGetLastError()` of its launch. A missing `nvcc` or a failed build
raises: the card never runs anything but the kernels built here.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

__all__ = ["load_library", "build_log", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "build")
_LIB = os.path.join(_BUILD_DIR, "libmrhyde_torch_kernels.so")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_state = {"lib": None, "log": ""}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# entry point -> argtypes (see csrc/fused_p1_thermal.cu)
# the stage: mass, mass0, mass_is_scalar, alpha_u, alpha_t, transient
_STAGE = [_P, _D, _I, _D, _D, _I]
# tables and sizes: phi, grad, wts, Q, N0, N1
_TABLES = [_P, _P, _P, _I, _I, _I]
_SIGNATURES = {
    # u, kappa, kappa0, kappa_is_scalar, stage, tables, out, stream
    "thermal_node_state_f64": [_P, _P, _D, _I, *_STAGE, *_TABLES, _P, _P],
    "thermal_node_state_f32": [_P, _P, _D, _I, *_STAGE, *_TABLES, _P, _P],
    # u, S, dS, K, dK, stage, tables, out, jac, stream
    "thermal_node_full_f64": [_P, _P, _P, _P, _P, *_STAGE, *_TABLES, _P, _P,
                              _P],
    "thermal_node_full_f32": [_P, _P, _P, _P, _P, *_STAGE, *_TABLES, _P, _P,
                              _P],
}


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                       "build the mrhyde_tpu_torch kernels")


def _sources():
    return sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))


def _stale():
    if not os.path.exists(_LIB):
        return True
    t = os.path.getmtime(_LIB)
    return any(os.path.getmtime(s) > t for s in _sources())


def _build():
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d):\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stderr))
    os.replace(tmp, _LIB)
    return proc.stdout + proc.stderr


def load_library():
    """The bound kernel library, building it first if it is missing or
    older than a source."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        if _stale():
            _state["log"] = _build()
        lib = ctypes.CDLL(_LIB)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _state["lib"] = lib
        return lib


def build_log() -> str:
    """nvcc's output of the build this process ran (ptxas register and
    spill report), or "" when the library was already built."""
    return _state["log"]
