"""Where the time of the three B2 node kernels `thermal_node_state`,
`thermal_node_full` (csrc/fused_p1_thermal.cu) and `ns_node_full`
(csrc/fused_p1_ns.cu) goes, on one card: builds patched copies of a
tree's csrc/, each with a part of a kernel cut, and times each through
its C entry point on the cases of chip_smoke.py's phases 3, 3b, 3d and
3i (f64 and f32, the divisible shapes, or the thermal kernels at
`--state-shape`; ns_node_full also at quadrature 8, Q = 25, on
1000x243).

    python tools/node_ablate.py [--csrc DIR] [--kinds K,...] [--out DIR]
                                [--state-shape N0,N1] [VARIANT ...]

`--csrc` (default: this tree's) is the csrc/ directory to build, such as
that of an unpacked `git archive` of an earlier commit; another tree's
kernels are timed as they are (`base` only: the patches match this
tree's sources; `--kinds` chooses its kernels), and since the C
interfaces are the same, this tree's argument code (`_launch.py`,
`fused_ns._ns_node_args`) fills them. Variants (default: all, or `base`
alone with `--kinds`) are listed in VARIANTS; `base` is the kernel as it
is, timed on the kernels that the chosen variants cut (on all where only
`base` is named). Each variant builds into DIR/<tree>/<variant> (default
tree_copies/ablate, listed in .gitignore; <tree> is `current`, or
`other` for another tree's csrc/) with the flags of ops/_build.py, all
nvcc at once; ptxas's report goes to DIR/<tree>/ptxas.txt.

Prints one JSON line per (case, variant): `ms`, the median of 5 batches
of 20 back-to-back launches of the C entry point (CUDA events);
`single_ms`, the median of 20 single launches of it, each between two
events; and the largest difference of its outputs from `base`'s relative
to max |base| (the cut variants change them). With the default `--csrc`,
`base` also times the Python wrapper that the port calls
(`wrapper_single_ms`, `wrapper_ms` batched, as `single_ms` and `ms`):
its host time before the launch is `wrapper_single_ms - single_ms`.
"""

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from full_ablate import patched  # noqa: E402
from mrhyde_tpu_torch.ops import _build  # noqa: E402
from mrhyde_tpu_torch.ops import fused_ns as fn  # noqa: E402
from mrhyde_tpu_torch.ops import fused_p1 as fp  # noqa: E402
from mrhyde_tpu_torch.ops._launch import (coeff_args, stage_args,  # noqa
                                          velocity_args)

THERMAL, NS = "fused_p1_thermal.cu", "fused_p1_ns.cu"
WALK = "node_walk.cuh"
CSRC = os.path.join(REPO, "mrhyde_tpu_torch", "ops", "csrc")
_NEVER = "T(1.2345e30)"
# ns_node_full at quadrature 8 (phase 3i's case)
NS_Q25 = (8, (1000, 243))

# the Jacobian passes' dual density replaced by a copy of its inputs
_COPY = ("#pragma unroll\n    for (int o = 0; o < kOuts; ++o)\n"
         "      out[o] = o < kVars ? u[o] : g[(o - kVars) / 2]"
         "[(o - kVars) % 2];\n    if (Q < 0) ")
# variant -> [(file, text of the file, its replacement)]
VARIANTS = {
    "base": [],
    # thermal_node_state: the tables, the patch and the stores only (no
    # element's quadrature: its rows are zeros)
    "state_loads_stores": [(
        WALK, "      if (a >= 0 && a < N0 && b >= 0 && b < N1) {\n"
        "        T uc[4 * NV];",
        "      if (N0 < 0 && a >= 0 && a < N0 && b >= 0 && b < N1) {\n"
        "        T uc[4 * NV];")],
    # the runtime-Q instance at Q = 4 (its loop rolled, the (E, Q)
    # coefficients in 8- or 4-byte loads at each qp)
    "state_no_q4": [(THERMAL, "  auto launch = Q == 4 ?",
                     "  auto launch = Q == -4 ?")],
    # blocks per SM for the registers: 4 everywhere (with the velocity
    # lane too), 2 everywhere
    "state_min4": [(THERMAL, "return ADVECT ? 2 : 4;",
                    "return ADVECT ? 4 : 4;")],
    "state_min2": [(THERMAL, "return ADVECT ? 2 : 4;",
                    "return ADVECT ? 2 : 2;")],
    # thermal_node_full (the walk's residual, then the Jacobian
    # sweep): the sweep's reads and stores only, no qp arithmetic
    "full_loads_stores": [(
        THERMAL, "      T aj[NKJ], ar[NKR];\n      qp_scalars<T, 2, 4, "
        "TRANSIENT, ADVECT>(in, uc, grad, Q, q, alpha_u,",
        "      if (Q > 0) {\n        J[0] += in.ds + in.k + in.dk + in.m +"
        " in.b[0] + in.b[1] + uc[0];\n        continue;\n      }\n"
        "      T aj[NKJ], ar[NKR];\n      qp_scalars<T, 2, 4, TRANSIENT, "
        "ADVECT>(in, uc, grad, Q, q, alpha_u,")],
    # no Jacobian sweep (the walk's residual alone)
    "full_no_jacobian": [(THERMAL, "  for (; e < e1; e += kThreads) {",
                          "  for (; Q < 0 && e < e1; e += kThreads) {")],
    # the Jacobian rows written with streaming stores
    "full_stream": [(THERMAL, "    for (int k = 0; k < 16; ++k) jac[k * E "
                     "+ e] = J[k];", "    for (int k = 0; k < 16; ++k) "
                     "__stcs(&jac[k * E + e], J[k]);")],
    # tiles of 8 x 64 elements (7 x 63 nodes) instead of 16 x 32
    # (thermal_node_state takes the same tiles in this build, and is
    # not timed)
    "full_tile8x64": [(THERMAL, "using NodeTile = WalkTile<16, 32, "
                       "kThreads>;", "using NodeTile = WalkTile<8, 64, "
                       "kThreads>;")],
    # blocks per SM for the registers: 1 (255 registers) or 3 (85)
    "full_min1": [(THERMAL, "constexpr int kFullMinBlocks = 2;",
                   "constexpr int kFullMinBlocks = 1;")],
    "full_min3": [(THERMAL, "constexpr int kFullMinBlocks = 2;",
                   "constexpr int kFullMinBlocks = 3;")],
    # ns_node_full: no halo densities (the first row and column of a
    # tile's nodes miss them)
    "ns_no_halo": [(NS, "for (int k = tid; k < kHalo * Q; k += kThreads)",
                    "for (int k = tid; k < 0; k += kThreads)")],
    # no residual rows from the w = 0 pass
    "ns_no_rows": [(NS, "column_block<T, TR, true>(a, 0,",
                    "column_block<T, TR, false>(a, 0,")],
    # the Jacobian passes' dual density a copy of its inputs
    "ns_no_density": [(
        NS, "    ns_density<TR, 2, D, T, false, true>(\n",
        _COPY + "ns_density<TR, 2, D, T, false, true>(\n")],
    # no contraction: the density's tangents summed into the block
    "ns_no_contract": [(
        NS, "#pragma unroll\n    for (int cp = 0; cp < 4; ++cp) {\n"
        "      const T pcp = phi[cp * Q + q];",
        "#pragma unroll\n    for (int o = 0; o < kOuts; ++o)\n"
        "      J[o][0] += out[o].d[0] + out[o].d[1] + out[o].d[2];\n"
        "#pragma unroll\n    for (int cp = 0; cp < 0; ++cp) {\n"
        "      const T pcp = phi[cp * Q + q];")],
    # no Jacobian stores
    "ns_no_jac_store": [(
        NS, "      if (pos >= 0) jac[pos * E + e] = J[r][cp];",
        f"      if (pos >= 0 && J[r][cp] == {_NEVER})\n"
        "        jac[pos * E + e] = J[r][cp];")],
    # ns_density's quotients as written (no reciprocals)
    "ns_no_recip": [(NS, "T, false, true>(", "T, false, false>(")],
    # f64 at 3 blocks per SM (170 registers)
    "ns_f64_blocks3": [(NS, "return sizeof(T) == 8 ? 1 :",
                        "return sizeof(T) == 8 ? 3 :")],
}


def state_cases(dev, dtype, shape=cs.KERNEL_SHAPES[0]):
    """[(label, kind, C arguments without the stream, outputs, wrapper
    call)] of thermal_node_state: phase 3's four cases and phase 3d's
    four at `shape` (1024^2 by default)."""
    N0, N1 = shape
    gen = torch.Generator(device=dev).manual_seed(1234)
    tab, ip0 = cs.quad_tables(N0, N1, dev, dtype)
    u, kxy, mx, _full, _tr = cs.qp_inputs(N0, N1, tab, ip0, dev, dtype, gen)
    xs = cs.qp_xyz((N0, N1), ip0, tab.Q, dev, dtype)
    rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
           (4.0 * (xs[0] - 0.5)).contiguous()]
    st1 = fp.Stage(*cs.DIRK22_STAGE1, 1.0)
    todo = (("kappa=1.0", 1.0, None, None),
            ("kappa=1+0.5xy", kxy, None, None),
            ("dirk22 kappa=1.0 m=2.0", 1.0,
             fp.Stage(*cs.DIRK22_STAGE1, 2.0), None),
            ("dirk22 kappa=1+0.5xy m=1+0.5x", kxy,
             fp.Stage(*cs.DIRK22_STAGE1, mx), None),
            ("b=(2,1) kappa=1", 1.0, None, [2.0, 1.0]),
            ("dirk22 b=(2,1) kappa=0.5 m=1", 0.5, st1, [2.0, 1.0]),
            ("b rotating kappa=1", 1.0, None, rot),
            ("dirk22 b rotating kappa=0.5 m=1", 0.5, st1, rot))
    E = N0 * N1
    out = []
    for label, kappa, stage, vel in todo:
        res = torch.empty_like(u)
        args = (u.data_ptr(), *coeff_args(kappa, E, u, tab, "kappa"),
                *stage_args(stage, E, u, tab),
                *velocity_args(vel, E, u, tab), tab.t_phi.data_ptr(),
                tab.t_grad.data_ptr(), tab.t_wts.data_ptr(), tab.Q, N0, N1,
                res.data_ptr())
        out.append((f"thermal_node_state {label}", "state", args, (res,),
                    lambda k=kappa, s=stage, v=vel: fp.thermal_node_state(
                        u, k, tab, s, v)))
    return out


def full_cases(dev, dtype, shape=cs.KERNEL_SHAPES[0]):
    """[(label, kind, C arguments without the stream, outputs, wrapper
    call)] of thermal_node_full: phase 3's two cases (kappa = 1 + e*e,
    steady and at the DIRK-2,2 stage with m = 1) and phase 3d's four
    (the velocity (2, 1) and the rotating one, each steady and at that
    stage) at `shape` (1024^2 by default), on phase 3's inputs."""
    N0, N1 = shape
    gen = torch.Generator(device=dev).manual_seed(1234)
    tab, ip0 = cs.quad_tables(N0, N1, dev, dtype)
    u, _kxy, _mx, full, (ue, tr) = cs.qp_inputs(N0, N1, tab, ip0, dev,
                                                dtype, gen)
    xs = cs.qp_xyz((N0, N1), ip0, tab.Q, dev, dtype)
    rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
           (4.0 * (xs[0] - 0.5)).contiguous()]
    st1 = fp.Stage(*cs.DIRK22_STAGE1, 1.0)
    todo = (("kappa=1+e*e", (u, *full), None, None),
            ("dirk22 kappa=1+e*e m=1.0", (ue, *tr), st1, None),
            ("b=(2,1) kappa=1+e*e", (u, *full), None, [2.0, 1.0]),
            ("dirk22 b=(2,1) kappa=1+e*e m=1", (ue, *tr), st1, [2.0, 1.0]),
            ("b rotating kappa=1+e*e", (u, *full), None, rot),
            ("dirk22 b rotating kappa=1+e*e m=1", (ue, *tr), st1, rot))
    E = N0 * N1
    out = []
    for label, head, stage, vel in todo:
        res = torch.empty_like(u)
        jac = torch.empty((16, E), dtype=dtype, device=dev)
        args = (*(t.data_ptr() for t in head),
                *stage_args(stage, E, u, tab),
                *velocity_args(vel, E, u, tab), tab.t_phi.data_ptr(),
                tab.t_grad.data_ptr(), tab.t_wts.data_ptr(), tab.Q, N0, N1,
                res.data_ptr(), jac.data_ptr())
        out.append((f"thermal_node_full {label}", "full", args, (res, jac),
                    lambda h=head, s=stage, v=vel: fp.thermal_node_full(
                        *h, tab, s, v)))
    return out


def ns_cases(dev, dtype):
    """[(label, kind, NsArgs, outputs, wrapper call)] of ns_node_full:
    phase 3b's three cases at 1024x256 and the PSPG steady one at
    quadrature 8 (Q = 25) on 1000x243."""
    N0, N1 = cs.NS_SHAPES[0]
    gen = torch.Generator(device=dev).manual_seed(4321)
    tab, ip0 = cs.quad_tables(N0, N1, dev, dtype, 5.0, 1.0)
    h = math.sqrt(sum(tab.wts))
    ue, ud, visc = cs.ns_inputs(N0, N1, tab, ip0, dev, dtype, gen)
    steady = fn.NSForm(True, False, h, 1.0, False)
    stage = fn.NSForm(True, True, h, 0.01, True)
    todo = [("pspg steady nu=1.0", (ue, None, (1.0, 1.0, 1.0, 0.0), tab,
                                    steady, cs.ns_rows(True, False, False,
                                                       False), None)),
            ("pspg steady nu=0.1+0.01x",
             (ue, None, (1.0, visc, 1.0, 0.0), tab, steady,
              cs.ns_rows(True, False, False, True), None)),
            ("pspg+supg dirk22 stage 1",
             (ue, ud, (1.0, 1.0, 1.0, 0.0), tab, stage,
              cs.ns_rows(True, True, True, False),
              fp.Stage(*cs.NS_STAGE1, None)))]
    quad, (N0, N1) = NS_Q25
    tq, iq = cs.quad_tables(N0, N1, dev, dtype, 5.0, 1.0, quadrature=quad)
    hq = math.sqrt(sum(tq.wts))
    uq = cs.ns_inputs(N0, N1, tq, iq, dev, dtype, gen)[0]
    todo.append((f"pspg steady nu=1.0 Q={tq.Q}",
                 (uq, None, (1.0, 1.0, 1.0, 0.0), tq,
                  fn.NSForm(True, False, hq, 1.0, False),
                  cs.ns_rows(True, False, False, False), None)))
    out = []
    for label, args in todo:
        a, res, jac, keep = fn._ns_node_args(*args)
        a._keep = keep
        out.append((f"ns_node_full {label}", "ns", a, (res, jac),
                    lambda x=args: fn.ns_node_full(*x)))
    return out


def batched(call, reps=20):
    """Median of 5 batches of `reps` back-to-back calls (CUDA events)."""
    call()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(reps):
            call()
        t1.record()
        t1.synchronize()
        times.append(t0.elapsed_time(t1) / reps)
    return statistics.median(times)


def _runs(variant, kind, kinds):
    """Whether a variant runs on a case of this kind ('state', 'full' or
    'ns'): `base` on the kinds the chosen variants cut, the others on
    their kernel's."""
    if variant == "base":
        return kind in kinds
    return variant.startswith(kind + "_")


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--csrc", default=CSRC)
    p.add_argument("--kinds", help="the kernels to time, of "
                   "state,full,ns (default: those the named variants "
                   "cut; all where none is named)")
    p.add_argument("--out", default=os.path.join(REPO, "tree_copies",
                                                 "ablate"))
    p.add_argument("--state-shape", default="1024,1024",
                   help="the thermal kernels' element grid N0,N1")
    p.add_argument("variants", nargs="*")
    opts = p.parse_args()
    shape = tuple(int(n) for n in opts.state_shape.split(","))
    own = os.path.abspath(opts.csrc) == CSRC
    # all variants by default; `base` alone with --kinds or another tree
    default = () if opts.kinds or not own else VARIANTS
    names = ["base"] + [v for v in (opts.variants or default)
                        if v != "base"]
    if not own and names != ["base"]:
        raise SystemExit("another tree's csrc/ is timed with `base` only")
    kinds = set(opts.kinds.split(",")) if opts.kinds else {
        v.split("_")[0] for v in names if v != "base"} or {
        "state", "full", "ns"}
    out_dir = os.path.join(opts.out, "current" if own else "other")
    os.makedirs(out_dir, exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    nvcc = _build._nvcc()
    jobs = {}
    for name in names:
        d = patched(opts.csrc, out_dir, name, VARIANTS[name])
        for kinds_of, src in ((("state", "full"), THERMAL), (("ns",), NS)):
            if not any(_runs(name, k, kinds) for k in kinds_of):
                continue
            kind = kinds_of[0]
            lib = os.path.join(d, src[:-3] + ".so")
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", d, "-o", lib,
                   os.path.join(d, src)]
            jobs[name, kind] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    if own:
        _build.load_library()
    todo = []
    for dtype in (torch.float64, torch.float32):
        if "state" in kinds:
            todo += [(dtype, *c) for c in state_cases(dev, dtype, shape)]
        if "full" in kinds:
            todo += [(dtype, *c) for c in full_cases(dev, dtype, shape)]
        if "ns" in kinds:
            todo += [(dtype, *c) for c in ns_cases(dev, dtype)]
    libs = {}
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as log:
        for (name, kind), (lib, proc) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {name}:\n{text[-3000:]}")
            log.write(f"==== {name} {kind}\n{text}\n")
            libs[name, kind] = ctypes.CDLL(lib)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for dtype, label, kind, args, outs, wrapper in todo:
        suffix = "f64" if dtype == torch.float64 else "f32"
        base = None
        for name in names:
            if not _runs(name, kind, kinds):
                continue
            entry = {"state": "thermal_node_state_",
                     "full": "thermal_node_full_",
                     "ns": "ns_node_full_"}[kind] + suffix
            fnc = getattr(libs[name, "ns" if kind == "ns" else "state"],
                          entry)
            fnc.argtypes = _build._SIGNATURES[entry]
            fnc.restype = ctypes.c_int
            cargs = ((ctypes.addressof(args), stream) if kind == "ns"
                     else args + (stream,))

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
            rec = {"case": label, "dtype": suffix, "variant": name,
                   "ms": batched(call), "single_ms": cs.cuda_ms(call),
                   "rel_diff_from_base": diff}
            if name == "base" and own:
                rec["wrapper_ms"] = batched(wrapper)
                rec["wrapper_single_ms"] = cs.cuda_ms(wrapper)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
