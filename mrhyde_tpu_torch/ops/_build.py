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

The module-set kernels are generated per deck (functions/codegen.py): a
source, which includes the kernel template `csrc/set_node.cuh` (2D p1
quads) or `csrc/set_elem.cuh` (hex and p2 quads), goes to
`ops/build/gen/<sha of its text>.cu` and builds with the same flags into
`ops/build/gen/lib<sha>.so` at the first use of that text (stale when a
`csrc/*.cuh` header is newer); `load_generated` loads each such library
by its own path, outside the one-owner namespace of the csrc/*.cu entry
points. `build_generated` builds several sources at once, one nvcc each.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import types

from mrhyde_tpu_torch.utils.profiling import timed

__all__ = ["load_library", "build_log", "NVCC_FLAGS", "load_generated",
           "build_generated"]

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_HERE, "csrc")
_BUILD_DIR = os.path.join(_HERE, "build")
_GEN_DIR = os.path.join(_BUILD_DIR, "gen")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_state = {"lib": None, "log": "", "gen": {}}

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


def _stale(src, lib=None):
    """A library is stale when older than its source or than a header of
    csrc/ (the sources include them, e.g. dual.cuh)."""
    lib = lib or _lib_of(src)
    deps = [src, *glob.glob(os.path.join(_SRC_DIR, "*.cuh"))]
    return not os.path.exists(lib) or \
        max(os.path.getmtime(d) for d in deps) > os.path.getmtime(lib)


def _build(srcs, lib_of=_lib_of):
    """Compile the sources in parallel, one nvcc each; returns nvcc's
    output (ptxas register and spill report) of each of them."""
    if not srcs:
        return {}
    return _nvcc_batch(srcs, lib_of)


@timed("ops::build")
def _nvcc_batch(srcs, lib_of):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    jobs = []
    for src in srcs:
        tmp = f"{lib_of(src)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", _SRC_DIR, "-o", tmp, src]
        jobs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    logs, failed = {}, []
    for src, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs[src] = out
        if proc.returncode != 0:
            failed.append("nvcc failed (exit %d):\n%s\n%s" % (
                proc.returncode, " ".join(cmd), out))
        else:
            os.replace(tmp, lib_of(src))
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def load_library():
    """The bound entry points of every kernel library (a namespace of
    ctypes functions), building the libraries first if one is missing or
    older than its source."""
    with _lock:
        if _state["lib"] is not None:
            return _state["lib"]
        _state["log"] = "".join(
            _build([s for s in _sources() if _stale(s)]).values())
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


def _gen_paths(text):
    from mrhyde_tpu_torch.functions.codegen import source_hash
    name = source_hash(text)
    return (os.path.join(_GEN_DIR, f"{name}.cu"),
            os.path.join(_GEN_DIR, f"lib{name}.so"))


def _gen_lib_of(src):
    stem = os.path.splitext(os.path.basename(src))[0]
    return os.path.join(_GEN_DIR, f"lib{stem}.so")


def build_generated(texts):
    """Builds the generated sources that are missing or stale, one nvcc
    each, all at once; returns {sha name: nvcc's output} of those
    built."""
    os.makedirs(_GEN_DIR, exist_ok=True)
    todo = []
    for text in dict.fromkeys(texts):
        src, lib = _gen_paths(text)
        if not os.path.exists(src) or open(src).read() != text:
            with open(f"{src}.{os.getpid()}.tmp", "w") as f:
                f.write(text)
            os.replace(f"{src}.{os.getpid()}.tmp", src)
        if _stale(src, lib):
            todo.append(src)
    logs = _build(todo, _gen_lib_of)
    return {os.path.basename(src)[:-3]: out for src, out in logs.items()}


def load_generated(text):
    """The bound entry points of the library of one generated source
    (set_node_full_*, set_node_state_* or set_elem_full_*,
    set_elem_state_*, each _f64 and _f32: those it defines), building it
    first if it is missing or stale."""
    src, lib = _gen_paths(text)
    with _lock:
        if lib in _state["gen"]:
            return _state["gen"][lib]
    build_generated([text])
    with _lock:
        if lib not in _state["gen"]:
            cdll = ctypes.CDLL(lib)
            fns = {}
            for name in (f"set_{kind}_{mode}_{t}"
                         for kind in ("node", "elem")
                         for mode in ("full", "state")
                         for t in ("f64", "f32")):
                if not hasattr(cdll, name):
                    continue
                fn = getattr(cdll, name)
                fn.argtypes = [_P, _P]
                fn.restype = ctypes.c_int
                fns[name] = fn
            _state["gen"][lib] = types.SimpleNamespace(**fns)
        return _state["gen"][lib]


def build_log() -> str:
    """nvcc's output of the build this process ran (ptxas register and
    spill report), or "" when the libraries were already built."""
    return _state["log"]
