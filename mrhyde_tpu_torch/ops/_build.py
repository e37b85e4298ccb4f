"""Build and bind the port's CUDA kernels.

`nvcc` compiles each `csrc/*.cu` of the package (with the headers of
`csrc/` it includes) into a shared library of its own with a plain C
interface, at first use, into `ops/build/`
(listed in .gitignore): one `nvcc` per source, all started together, so
the build takes the time of the slowest source. ctypes binds them.
Pointers and the stream are passed as `c_void_p`, and every entry point
returns the `cudaGetLastError()` of its launch. A missing `nvcc` or a
failed build raises: the card never runs anything but the kernels built
here.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import types

__all__ = ["load_library", "build_log", "NVCC_FLAGS"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_state = {"lib": None, "log": ""}

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# entry point -> argtypes
# csrc/fused_p1_thermal.cu; the stage: mass, mass0, mass_is_scalar,
# alpha_u, alpha_t, transient; tables and sizes: phi, grad, wts, Q, N0, N1
_STAGE = [_P, _D, _I, _D, _D, _I]
# the velocity: advect, then (pointer, scalar) of each of three components
_VEL = [_I, _P, _D, _P, _D, _P, _D]
_TABLES = [_P, _P, _P, _I, _I, _I]
# the element kernels' tables and geometry: phi, grad, wts, Q, nc, dim,
# lattice offsets (a host int array of nc*dim), stride, N0, N1, N2
_ELEM = [_P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _I]
_SIGNATURES = {
    # u, kappa, kappa0, kappa_is_scalar, stage, velocity, tables, out,
    # stream
    "thermal_node_state_f64": [_P, _P, _D, _I, *_STAGE, *_VEL, *_TABLES, _P,
                               _P],
    "thermal_node_state_f32": [_P, _P, _D, _I, *_STAGE, *_VEL, *_TABLES, _P,
                               _P],
    # u, S, dS, K, dK, stage, velocity, tables, out, jac, stream
    "thermal_node_full_f64": [_P, _P, _P, _P, _P, *_STAGE, *_VEL, *_TABLES,
                              _P, _P, _P],
    "thermal_node_full_f32": [_P, _P, _P, _P, _P, *_STAGE, *_VEL, *_TABLES,
                              _P, _P, _P],
    # csrc/fused_p1_ns.cu: the host address of an NsArgs, stream
    "ns_node_full_f64": [_P, _P],
    "ns_node_full_f32": [_P, _P],
    # csrc/fused_elem_ns.cu: the host address of an ElemNsArgs, stream
    "ns_elem_full_f64": [_P, _P],
    "ns_elem_full_f32": [_P, _P],
    # csrc/fused_elem_thermal.cu: grid, kappa / S, dS, K, dK, stage,
    # velocity, element geometry, rows (, jac), stream
    "thermal_elem_state_f64": [_P, _P, _D, _I, *_STAGE, *_VEL, *_ELEM, _P,
                               _P],
    "thermal_elem_state_f32": [_P, _P, _D, _I, *_STAGE, *_VEL, *_ELEM, _P,
                               _P],
    "thermal_elem_full_f64": [_P, _P, _P, _P, _P, *_STAGE, *_VEL, *_ELEM,
                              _P, _P, _P],
    "thermal_elem_full_f32": [_P, _P, _P, _P, _P, *_STAGE, *_VEL, *_ELEM,
                              _P, _P, _P],
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


def _lib_of(src):
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_BUILD_DIR, f"lib{stem}.so")


def _stale(src):
    """A library is stale when older than its source or than a header of
    csrc/ (the sources include them, e.g. dual.cuh)."""
    lib = _lib_of(src)
    deps = [src, *glob.glob(os.path.join(_SRC_DIR, "*.cuh"))]
    return not os.path.exists(lib) or \
        max(os.path.getmtime(d) for d in deps) > os.path.getmtime(lib)


def _build(srcs):
    """Compile the sources in parallel, one nvcc each; returns nvcc's
    output (ptxas register and spill report) of all of them."""
    if not srcs:
        return ""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in srcs:
        tmp = f"{_lib_of(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, src]
        jobs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = [], []
    for src, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0:
            failed.append("nvcc failed (exit %d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), out))
        else:
            os.replace(tmp, _lib_of(src))
    if failed:
        raise RuntimeError("\n".join(failed))
    return "".join(logs)


def load_library():
    """The bound entry points of every kernel library (a namespace of
    ctypes functions), building the libraries first if one is missing or
    older than its source."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        _state["log"] = _build([s for s in _sources() if _stale(s)])
        libs = [ctypes.CDLL(_lib_of(s)) for s in _sources()]
        fns = {}
        for name, argtypes in _SIGNATURES.items():
            owners = [lib for lib in libs if hasattr(lib, name)]
            if len(owners) != 1:
                raise RuntimeError(f"kernel entry point {name} found in "
                                   f"{len(owners)} libraries, expected 1")
            fn = getattr(owners[0], name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            fns[name] = fn
        _state["lib"] = types.SimpleNamespace(**fns)
        return _state["lib"]


def build_log() -> str:
    """nvcc's output of the build this process ran (ptxas register and
    spill report), or "" when the libraries were already built."""
    return _state["log"]
