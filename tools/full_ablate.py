"""Where the time of the scalar element kernels `thermal_elem_full` and
`thermal_elem_state` (csrc/fused_elem_thermal.cu) and of the module-set
node kernels `set_node_full` and `set_node_state` (csrc/set_node.cuh)
goes, on one card: builds patched copies of a tree's csrc/, each with a
part of a kernel cut, and times each on the cases of chip_smoke.py's
phases 3c, 3d, 3f, 3h (set_node_state's 2D p1 cases, at both shapes)
and 3i (f64, the divisible shapes; thermal_elem_state and set_node_state
f64 and f32).

    python tools/full_ablate.py [--csrc DIR] [--kinds K,...] [--out DIR]
                                [--ptx] [VARIANT ...]

`--ptx` instead reports, for each kernel of phase 3h's 2D p1 generated
sources, whether its PTX evaluates a sin or a cos
(tools/engine_ablate.py `ptx_trig`).
`--csrc` (default: this tree's) is the csrc/ directory to build, such as
that of an unpacked `git archive` of an earlier commit; another tree's
kernels are timed as they are (`base` only: the patches match this
tree's sources; `--kinds` chooses its kernels), and since the C
interfaces are the same, this tree's wrappers fill the arguments.
Variants (default: all, or `base` alone with `--kinds`) are listed in
VARIANTS; `base` is the kernel as it is, timed on the kernels that the
chosen variants cut (on all where only `base` is named). Each variant
builds into DIR/<tree>/<variant> (default tree_copies/ablate, listed in
.gitignore; <tree> is `current`, or `other` for another tree's csrc/)
with the flags of ops/_build.py, all nvcc at once; ptxas's report goes
to DIR/<tree>/ptxas.txt. Prints one JSON line per (case, variant): the
median of 3 batches of 10 back-to-back launches (CUDA events;
thermal_elem_state and set_node_state: `ms` the median of 5 batches of
20 and `single_ms` the median of 20 single launches, as
tools/node_ablate.py times them; with the default `--csrc` the Python
wrapper's `wrapper_ms` and `wrapper_single_ms` beside `base`, its host
time before the launch being `wrapper_single_ms - single_ms`; beside
set_node_state's `base` its bound, chip_smoke.py's `state_work` and
`bound`, and `share`, the bound over `ms`), and the largest difference
of its outputs from `base`'s relative to max |base| (the cut variants
change them). First it prints the cuBLAS time of the contraction alone
(torch.matmul of the same GEMM shapes, f64), a yardstick that no path of
the port calls."""

import argparse
import ctypes
import json
import math
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import engine_ablate  # noqa: E402
from mrhyde_tpu_torch.ops import _build  # noqa: E402
from mrhyde_tpu_torch.ops import fused_elem as fe  # noqa: E402
from mrhyde_tpu_torch.ops import fused_set as fs  # noqa: E402
from mrhyde_tpu_torch.ops._launch import (coeff_args, stage_args,  # noqa
                                          velocity_args)
from mrhyde_tpu_torch.ops.fused_p1 import QUAD_P1, Stage  # noqa: E402

THERMAL, SET_NODE = "fused_elem_thermal.cu", "set_node.cuh"
WALK = "node_walk.cuh"
FORM = "thermal_form.cuh"
ENGINE = engine_ablate.ENGINE
_NEVER = "T(1.2345e30)"
CSRC = os.path.join(REPO, "mrhyde_tpu_torch", "ops", "csrc")
# the tile walk with one set of rows: a second barrier after the sums
_SINGLE_ROWS = [
    (WALK, "    T* rw = rows + cur * NV * 4 * kTileElems;",
     "    T* rw = rows;"),
    (WALK, "    t = tn;\n    i0 = i0n;", "    __syncthreads();\n    t = tn;\n"
     "    i0 = i0n;"),
    (WALK, "return 2LL * nv * kPatch + 2LL * nv * 4 * kTileElems;",
     "return 2LL * nv * kPatch + 1LL * nv * 4 * kTileElems;")]
# variant -> [(file, text of the file, its replacement)]
VARIANTS = {
    "base": [],
    # thermal_elem_full: f64 on FMA (each lane's form of the m8n8k4
    # step, as f32) instead of DMMA
    "thermal_fma": [(FORM, "  static constexpr bool value = "
                     "std::is_same<T, double>::value;",
                     "  static constexpr bool value = false;")],
    # no Jacobian contraction (its rows stored as zeros)
    "thermal_no_jac_contract": [(
        THERMAL, "        for (int k = 0; k < NKJ; ++k) {\n",
        "        for (int k = 0; k < 0; ++k) {\n")],
    # no Jacobian stores
    "thermal_no_jac_store": [(
        THERMAL,
        "          if (k < NC * NC) a.jac[(long long)k * geo.E + e] = "
        "cj[n][i];",
        f"          if (k < NC * NC && cj[n][i] == {_NEVER})\n"
        "            a.jac[(long long)k * geo.E + e] = cj[n][i];")],
    # thermal_elem_state (f64 octets, f32 a thread per element, two
    # per thread): the gathers, the (E, Q) reads and the row stores
    # only, no qp arithmetic
    "state_loads_stores": [
        (THERMAL, "        const T* tq = tb + (long long)qq * L::PQ;\n",
         "        const T* tq = tb + (long long)qq * L::PQ;\n"
         "        if (Q > 0) {\n#pragma unroll\n"
         "          for (int j = 0; j < EL; ++j) {\n"
         "            res[j][0] += cur[j].k + cur[j].m + cur[j].b[0] + "
         "uc[j][0] + uc[j][NC - 1];\n"
         "            cur[j] = load_state<T, DIM, TRANSIENT, ADVECT>(\n"
         "                a, valid[j] && qq + 1 < nq,\n"
         "                (e0 + j * kThreads) * Q + q0 + qq + 1);\n"
         "          }\n          continue;\n        }\n"),
        (THERMAL, "          const T* fq = fr + (long long)qq * L::NF * "
         "32;\n          // linearize: pair p's C fragment",
         "          const T* fq = fr + (long long)qq * L::NF * 32;\n"
         "          if (Q > 0) {\n            cr[0][0] += cur.k + cur.m + "
         "cur.b[0] + ua[0];\n            cur = nxt;\n            "
         "continue;\n          }\n          // linearize: pair p's C "
         "fragment")],
    # f64 on FMA (each lane's form of the m8n8k4 step) instead of DMMA
    "state_fma": [(FORM, "  static constexpr bool value = "
                   "std::is_same<T, double>::value;",
                   "  static constexpr bool value = false;")],
    # hex f64 octets at 2 blocks per SM (128 registers) instead of 4
    "state_octets_min2": [(
        THERMAL, "  static constexpr int kMinBlocks = kOctets || sizeof(T) "
        "== 4 ? 4 : 2;", "  static constexpr int kMinBlocks = kOctets ? 2"
        " : (sizeof(T) == 4 ? 4 : 2);")],
    # f64 by the thread per element everywhere (hex too), two per
    # thread
    "state_rows_f64": [(
        THERMAL, "  static constexpr bool kOctets = std::is_same<T, "
        "double>::value && NC == 8;", "  static constexpr bool kOctets = "
        "false;")],
    # the thread per element with one element per thread in f64 too
    "state_one_element": [(
        THERMAL, "  static constexpr int kElems =\n      sizeof(T) == 8 && "
        "!(TRANSIENT && ADVECT) ? 2 : 1;",
        "  static constexpr int kElems = 1;")],
    # the largest L1 the card's shared memory leaves (the state
    # kernels' per-qp loads are L1 hits)
    "state_max_l1": [(
        THERMAL, "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,"
        " kernel, kThreads,\n                                          "
        "        smem);",
        "    if (!JAC)\n      cudaFuncSetAttribute(kernel, "
        "cudaFuncAttributePreferredSharedMemoryCarveout, 0);\n"
        "    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,"
        " kThreads,\n                                                  "
        "smem);")],
    # set_node_full: no Jacobian blocks launched
    "set_residual_blocks": [(
        SET_NODE, "    jac_blocks = (E + elems - 1) / elems;",
        "    jac_blocks = 0;")],
    # the residual blocks return at once
    "set_jacobian_blocks": [(
        SET_NODE, "  if (blockIdx.x >= jac_blocks) {\n",
        "  if (blockIdx.x >= jac_blocks) {\n    if (a.Q > 0) return;\n")],
    # the Jacobian role's pass width (kTanNode: 0 is one pass per
    # variable), element cap and blocks per SM at a stage
    "set_tan2": [(ENGINE, "constexpr int kTanNode = 0;",
                  "constexpr int kTanNode = 2;")],
    "set_tan3": [(ENGINE, "constexpr int kTanNode = 0;",
                  "constexpr int kTanNode = 3;")],
    "set_tan4": [(ENGINE, "constexpr int kTanNode = 0;",
                  "constexpr int kTanNode = 4;")],
    "set_elems16": [(SET_NODE, "constexpr int kNodeElems = 32;",
                     "constexpr int kNodeElems = 16;")],
    "set_blocks3": [(SET_NODE, "return transient ? 4 : kMinBlocks;",
                     "return transient ? 3 : kMinBlocks;")],
    # the per-column Jacobian role at every Q, or the engine at every Q
    "set_columns": [(SET_NODE, "return NV == 1 || Q > kQc;",
                     "return Q > 0;")],
    "set_engine": [(SET_NODE, "return NV == 1 || Q > kQc;",
                    "return Q < 0;")],
    # the engine's linearization with its density replaced by a copy
    # of its inputs, or without the contraction and its stores
    # (tools/engine_ablate.py's `nodensity`, `nocontract`)
    "set_no_density": engine_ablate.VARIANTS["nodensity"],
    "set_no_contract": engine_ablate.VARIANTS["nocontract"],
    # set_node_state (the tile walk): the tables, the patches, the
    # rows and the sums, no element's quadrature (its rows zeros)
    "setstate_loads_stores": [(
        WALK, "      if (a >= 0 && a < N0 && b >= 0 && b < N1) {\n"
        "        T uc[4 * NV];",
        "      if (N0 < 0 && a >= 0 && a < N0 && b >= 0 && b < N1) {\n"
        "        T uc[4 * NV];")],
    # the tangent-only density pass replaced by a copy of its inputs
    "setstate_no_density": [(
        SET_NODE, "      Dens::template eval<TR, D>(zu, zud, zg, x0 + "
        "t.off[0], y0 + t.off[1],\n                                 a, "
        "zo);",
        "#pragma unroll\n      for (int k = 0; k < 3 * NV; ++k)\n"
        "        zo[k] = k < NV ? zu[k] : zg[(k - NV) / 2]"
        "[(k - NV) % 2];")],
    # the runtime-Q instance at Q = 4 (its qp loop rolled)
    "setstate_no_q4": [(SET_NODE, "  return a.Q == 4 ? set_state_case",
                        "  return a.Q == -4 ? set_state_case")],
    # a thread's two elements computed at once
    "setstate_unroll2": [(SET_NODE, "constexpr int kStateUnroll = 1;",
                          "constexpr int kStateUnroll = 2;")],
    # one set of rows (two barriers per tile, 51 KB a block in f64),
    # at 2, 3 or 4 blocks per SM (the registers' bound)
    "setstate_single": _SINGLE_ROWS,
    "setstate_single_min3": _SINGLE_ROWS + [
        (SET_NODE, "constexpr int kStateMinBlocks = 2;",
         "constexpr int kStateMinBlocks = 3;")],
    "setstate_single_min4": _SINGLE_ROWS + [
        (SET_NODE, "constexpr int kStateMinBlocks = 2;",
         "constexpr int kStateMinBlocks = 4;")],
    # tiles of 8 x 32 elements, one per thread (42 KB a block in f64)
    "setstate_tile8x32": [(SET_NODE, "using StateTile = WalkTile<16, 32,"
                           " 256>;", "using StateTile = WalkTile<8, 32, "
                           "256>;")],
    "setstate_tile8x32_min4": [
        (SET_NODE, "using StateTile = WalkTile<16, 32, 256>;",
         "using StateTile = WalkTile<8, 32, 256>;"),
        (SET_NODE, "constexpr int kStateMinBlocks = 2;",
         "constexpr int kStateMinBlocks = 4;")],
}
THERMAL_CASES = (("hex", 0), ("p2", 2))  # chip_smoke.ELEM_SHAPES index
# (label, dtype) -> chip_smoke.bound of a set_node_state case
BOUNDS = {}
SET_CASES = tuple(cs.SET_KERNEL_CASES)


def _kind(key):
    """The variant prefix of a case key: 'thermal' (thermal_elem_full),
    'state' (thermal_elem_state), a generated source (set_node_full) or
    ('setstate', a generated source) (set_node_state)."""
    if isinstance(key, tuple):
        return key[0]
    return key if key in ("thermal", "state") else "set"


def _text(key):
    """The generated source a case key runs, or None."""
    if isinstance(key, tuple):
        return key[1]
    return None if key in ("thermal", "state") else key


def _runs(variant, key, kinds):
    """Whether a variant runs on a case of this key: `base` on the kinds
    the chosen variants cut, the others on their kernel's."""
    if variant == "base":
        return _kind(key) in kinds
    return variant.startswith(_kind(key) + "_")


def patched(csrc, out, name, patches):
    """A copy of csrc with the variant's patches, in out/name."""
    d = os.path.join(out, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(csrc, d)
    for fname, old, new in patches:
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise SystemExit(f"{name}: {fname} no longer holds {old!r}")
        open(path, "w").write(text.replace(old, new))
    return d


def thermal_cases(dev):
    """[(label, 'thermal', C arguments, outputs)]: thermal_elem_full at
    phase 3c's and 3d's divisible shapes, f64: steady and DIRK-2,2 stage 1
    on the kappa = 1 + e*e inputs, and with the velocity (2, 1[, 0.5])
    steady and the rotating one at the stage (m = 1)."""
    f64 = torch.float64
    out = []
    for mesh, i in THERMAL_CASES:
        dims = cs.ELEM_SHAPES[i][1]
        gen = torch.Generator(device=dev).manual_seed(2468)
        tab, lat, q_off = cs.elem_tables(mesh, dims, dev, f64)
        u, _kxy, mx, full, (ue, tr) = cs.elem_inputs(dims, tab, lat, q_off,
                                                     dev, f64, gen)
        xs = cs.qp_xyz(dims, q_off, tab.Q, dev, f64)
        rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
               (4.0 * (xs[0] - 0.5)).contiguous(),
               (0.5 + 0.25 * xs[-1]).contiguous()][:tab.dim]
        const = [2.0, 1.0, 0.5][:tab.dim]
        todo = (("steady", (u, *full), None, None),
                ("stage", (ue, *tr), Stage(*cs.DIRK22_STAGE1, mx), None),
                ("advect b scalar", (u, *full), None, const),
                ("advect b rotating stage", (ue, *tr),
                 Stage(*cs.DIRK22_STAGE1, 1.0), rot))
        E, nc = math.prod(dims), tab.nc
        for label, head, stage, vel in todo:
            rows = torch.empty((nc, E), dtype=f64, device=dev)
            jac = torch.empty((nc * nc, E), dtype=f64, device=dev)
            args = (*(t.data_ptr() for t in head),
                    *stage_args(stage, E, head[0], tab),
                    *velocity_args(vel, E, head[0], tab),
                    *fe._geometry_args(head[0], tab, lat), rows.data_ptr(),
                    jac.data_ptr())
            # the arguments point into these tensors: keep them alive
            out.append((f"thermal_elem_full {mesh} {label}", "thermal",
                        args, (rows, jac), (head, tab, stage, vel)))
    return out


def state_cases(dev, dtype):
    """[(label, 'state', C arguments without the stream, outputs, wrapper
    call)]: thermal_elem_state at phase 3c's and 3d's divisible shapes
    (hex 128^3, p2 1024^2): kappa = 1 and 1 + 0.5 x y (z) steady, the
    decks' DIRK-2,2 stage with kappa and m scalar and phase 3c's with
    both per qp, and phase 3d's four advection cases."""
    out = []
    for mesh, i in THERMAL_CASES:
        dims = cs.ELEM_SHAPES[i][1]
        gen = torch.Generator(device=dev).manual_seed(2468)
        tab, lat, q_off = cs.elem_tables(mesh, dims, dev, dtype)
        u, kxy, mx, _full, _tr = cs.elem_inputs(dims, tab, lat, q_off, dev,
                                                dtype, gen)
        xs = cs.qp_xyz(dims, q_off, tab.Q, dev, dtype)
        rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
               (4.0 * (xs[0] - 0.5)).contiguous(),
               (0.5 + 0.25 * xs[-1]).contiguous()][:tab.dim]
        const = [2.0, 1.0, 0.5][:tab.dim]
        st1 = Stage(*cs.DIRK22_STAGE1, 1.0)
        xy, b3 = ("xyz", ",0.5") if mesh == "hex" else ("xy", "")
        todo = (("kappa=1.0", 1.0, None, None),
                (f"kappa=1+0.5{xy}", kxy, None, None),
                ("dirk22 kappa=1.0 m=1.0", 1.0, st1, None),
                (f"dirk22 kappa=1+0.5{xy} m=1+0.5x", kxy,
                 Stage(*cs.DIRK22_STAGE1, mx), None),
                (f"b=(2,1{b3}) kappa=1", 1.0, None, const),
                (f"dirk22 b=(2,1{b3}) kappa=0.5 m=1", 0.5, st1, const),
                ("b rotating kappa=1", 1.0, None, rot),
                ("dirk22 b rotating kappa=0.5 m=1", 0.5, st1, rot))
        E = math.prod(dims)
        for label, kappa, stage, vel in todo:
            rows = torch.empty((tab.nc, E), dtype=dtype, device=dev)
            args = (u.data_ptr(), *coeff_args(kappa, E, u, tab, "kappa"),
                    *stage_args(stage, E, u, tab),
                    *velocity_args(vel, E, u, tab),
                    *fe._geometry_args(u, tab, lat), rows.data_ptr())
            out.append((f"thermal_elem_state {mesh} {label}", "state", args,
                        (rows,), lambda k=kappa, s=stage, v=vel, t=tab, g=u,
                        la=lat: fe.thermal_elem_state(g, k, t, la, s, v)))
    return out


def set_cases(dev):
    """[(label, generated source, C arguments, outputs)]: set_node_full on
    phase 3f's five cases at 1024x256 and phase 3i's Q = 25 case, f64."""
    f64 = torch.float64
    out = []
    N0, N1 = cs.SET_SHAPES[0]
    for name in SET_CASES:
        _b, box, _al, _dt = cs.SET_KERNEL_CASES[name]
        gen = torch.Generator(device=dev).manual_seed(4321)
        tab, ip0 = cs.quad_tables(N0, N1, dev, f64, *box)
        form, sc, jac_idx, stage = cs.set_case(name, math.sqrt(sum(tab.wts)))
        geo = ((0.0, 0.0), (box[0] / N0, box[1] / N1), ip0)
        ue, ud = cs.set_inputs(len(form.variables), (N0, N1), QUAD_P1, dev,
                               f64, gen, stage)
        a, res, jac, keep = fs._node_args(form, ue, ud, sc, tab, geo,
                                          jac_idx, stage, False)
        out.append((f"set_node_full {name}", form.source,
                    (a, keep, ue, ud, tab), (res, jac)))
    _b, _mesh, quad, box, dims = cs.QUADRATURE_CASES["set_node_full"]
    gen = torch.Generator(device=dev).manual_seed(9753)
    tab, q_off = cs.quad_tables(*dims, dev, f64, *box, quadrature=quad)
    h = math.fsum(tab.wts) ** 0.5
    form, jac_idx = cs.quadrature_case("set_node_full", h)
    geo = ((0.0, 0.0), tuple(b / n for b, n in zip(box, dims)), q_off)
    ue = cs.set_inputs(len(form.variables), dims, QUAD_P1, dev, f64, gen,
                       None)[0]
    a, res, jac, keep = fs._node_args(form, ue, None, fs.SetScalars(
        0.0, 1.0, ()), tab, geo, jac_idx, None, False)
    out.append((f"set_node_full Q = {tab.Q}", form.source,
                (a, keep, ue, tab), (res, jac)))
    return out


def set_state_cases(dev, dtype):
    """[(label, ('setstate', generated source), C arguments, outputs,
    wrapper call)]: set_node_state on phase 3h's 2D p1 cases at both its
    shapes (1024^2, 1000x777)."""
    out = []
    for (name, (mesh, _b, box, _al, _dt)), dims in (
            (c, dims) for c in cs.STATE_KERNEL_CASES.items()
            for dims in cs.STATE_SHAPES["p1"]):
        if mesh != "p1":
            continue
        gen = torch.Generator(device=dev).manual_seed(1357)
        tab, q_off = cs.quad_tables(*dims, dev, dtype, *box)
        form, sc, stage = cs.state_case(name, math.fsum(tab.wts) ** 0.5)
        geo = ((0.0, 0.0), tuple(b / n for b, n in zip(box, dims)), q_off)
        u, _ = cs.set_inputs(len(form.variables), dims, QUAD_P1, dev, dtype,
                             gen, None)
        args = (form, u, sc, tab, geo, stage)
        a, res, _jac, keep = fs._node_args(form, u, None, sc, tab, geo, (),
                                           stage, True)
        label = f"set_node_state {name} {dims[0]}x{dims[1]}"
        BOUNDS[label, dtype] = cs.bound(*cs.state_work(
            dims, dtype, form, u, sc, tab, QUAD_P1, stage, True), dtype)
        out.append((label, ("setstate", form.source), (a, keep, u, tab),
                    (res,), lambda x=args: fs.set_node_state(*x)))
    return out


def matmul_yardstick(dev):
    """The cuBLAS time (torch.matmul, f64, CUDA events, median of 3
    batches of 10) of the contraction alone at phase 3c's and 3d's
    divisible shapes: (E x Q kinds) @ (Q kinds x nc^2), the GEMM of
    thermal_elem_full's Jacobian rows without their linearization. A
    yardstick only: no path of the port calls it."""
    out = []
    for mesh, i in THERMAL_CASES:
        dims = cs.ELEM_SHAPES[i][1]
        E = math.prod(dims)
        dim, nc, Q = (3, 8, 8) if mesh == "hex" else (2, 9, 9)
        for label, kinds in (("steady", 2 + dim), ("advect", 2 + 2 * dim)):
            a = torch.rand(E, Q * kinds, device=dev, dtype=torch.float64)
            b = torch.rand(Q * kinds, nc * nc, device=dev,
                           dtype=torch.float64)
            c = torch.empty(E, nc * nc, device=dev, dtype=torch.float64)
            torch.matmul(a, b, out=c)
            torch.cuda.synchronize()
            times = []
            for _ in range(3):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(10):
                    torch.matmul(a, b, out=c)
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) / 10)
            out.append({"yardstick": "torch.matmul", "mesh": mesh,
                        "shape": list(dims), "case": label,
                        "gemm": [E, Q * kinds, nc * nc],
                        "ms": sorted(times)[1]})
            del a, b, c
    return out


def batched(call, reps=20, n=5):
    """Median of n batches of `reps` back-to-back calls (CUDA events)."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            call()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return sorted(times)[n // 2]


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", default=CSRC)
    p.add_argument("--kinds", help="the kernels to time, of "
                   "thermal,state,set,setstate (default: those the named "
                   "variants cut; all where none is named)")
    p.add_argument("--out", default=os.path.join(REPO, "tree_copies",
                                                 "ablate"))
    p.add_argument("--ptx", action="store_true",
                   help="only report which kernels of phase 3h's 2D p1 "
                   "sources evaluate a sin or a cos (engine_ablate.ptx_trig)")
    p.add_argument("variants", nargs="*")
    opts = p.parse_args()
    if opts.ptx:
        dev = torch.device("cuda", 0)
        texts = sorted({c[1][1] for c in set_state_cases(dev,
                                                          torch.float64)})
        for (i, kernel, name), hit in engine_ablate.ptx_trig(
                texts, opts.csrc, os.path.join(opts.out, "ptx")).items():
            print(json.dumps({"source": i, "kernel": kernel, "entry": name,
                              "sin_cos": hit}), flush=True)
        return
    own = os.path.abspath(opts.csrc) == CSRC
    # all variants by default; `base` alone with --kinds or another tree
    default = () if opts.kinds or not own else VARIANTS
    names = ["base"] + [v for v in (opts.variants or default)
                        if v != "base"]
    if not own and names != ["base"]:
        raise SystemExit("another tree's csrc/ is timed with `base` only")
    kinds = set(opts.kinds.split(",")) if opts.kinds else {
        v.split("_")[0] for v in names if v != "base"} or {
        "thermal", "state", "set"}
    out_dir = os.path.join(opts.out, "current" if own else "other")
    os.makedirs(out_dir, exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    if "thermal" in kinds:
        for rec in matmul_yardstick(dev):
            print(json.dumps(rec), flush=True)
    todo = []
    if "thermal" in kinds:
        todo += [(torch.float64, *c) for c in thermal_cases(dev)]
    if "state" in kinds:
        for dtype in (torch.float64, torch.float32):
            todo += [(dtype, *c) for c in state_cases(dev, dtype)]
    if "set" in kinds:
        todo += [(torch.float64, *c, None) for c in set_cases(dev)]
    if "setstate" in kinds:
        for dtype in (torch.float64, torch.float32):
            todo += [(dtype, *c) for c in set_state_cases(dev, dtype)]
    nvcc = _build._nvcc()
    keys = {key for _d, _l, key, _a, _o, _w in todo}
    texts = sorted({_text(k) for k in keys} - {None})
    jobs = {}
    for name in names:
        d = patched(opts.csrc, out_dir, name, VARIANTS[name])
        srcs = {"thermal": os.path.join(d, THERMAL)}
        for i, text in enumerate(texts):
            srcs[text] = os.path.join(d, f"gen{i}.cu")
            open(srcs[text], "w").write(text)
        for key, src in srcs.items():
            if not any(_runs(name, k, kinds) for k in
                       (("thermal", "state") if key == "thermal" else
                        [k for k in keys if _text(k) == key])):
                continue
            lib = src[:-3] + ".so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", d, "-o", lib, src]
            jobs[name, key] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    if own and ("state" in kinds or "setstate" in kinds):
        _build.load_library()
    libs = {}
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as log:
        for (name, key), (lib, proc) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {name}:\n{text[-3000:]}")
            log.write(f"==== {name} {key if key == 'thermal' else key[:60]}"
                      f"\n{text}\n")
            libs[name, key] = ctypes.CDLL(lib)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for dtype, label, key, args, outs, wrapper in todo:
        base = None
        suffix = "f64" if dtype == torch.float64 else "f32"
        for name in names:
            if not _runs(name, key, kinds):
                continue
            if key == "thermal":
                fnc = libs[name, key].thermal_elem_full_f64
                fnc.argtypes = _build._SIGNATURES["thermal_elem_full_f64"]
                cargs = args + (stream,)
            elif key == "state":
                entry = f"thermal_elem_state_{suffix}"
                fnc = getattr(libs[name, "thermal"], entry)
                fnc.argtypes = _build._SIGNATURES[entry]
                cargs = args + (stream,)
            else:
                fnc = getattr(libs[name, _text(key)],
                              f"set_node_state_{suffix}"
                              if _kind(key) == "setstate"
                              else "set_node_full_f64")
                fnc.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
                cargs = (ctypes.addressof(args[0]), stream)
            fnc.restype = ctypes.c_int

            def call():
                err = fnc(*cargs)
                if err:
                    raise SystemExit(f"{name} {label}: launch error {err}")
            for o in outs:
                o.zero_()
            call()
            torch.cuda.synchronize()
            got = tuple(o.clone() for o in outs)
            base = base or got
            diff = max(float((o - b).abs().max()) /
                       max(float(b.abs().max()), 1e-300)
                       for o, b in zip(got, base))
            rec = {"case": label, "variant": name, "rel_diff_from_base": diff}
            if _kind(key) in ("state", "setstate"):
                rec.update(dtype=suffix, ms=batched(call),
                           single_ms=cs.cuda_ms(call))
                if name == "base" and own:
                    rec["wrapper_ms"] = batched(wrapper)
                    rec["wrapper_single_ms"] = cs.cuda_ms(wrapper)
                if name == "base" and (label, dtype) in BOUNDS:
                    rec.update(BOUNDS[label, dtype])
                    rec["share"] = rec["bound_ms"] / rec["ms"]
            else:
                rec["ms"] = batched(call, 10, 3)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
