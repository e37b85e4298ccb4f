"""Where the element-tile engine's time goes, on one card: builds patched
copies of csrc/elem_engine.cuh, each with a part of the kernel cut or a
constant changed, and times each on the cases of chip_smoke.py's phases 3e
and 3g (f64, the divisible shapes).

    python tools/engine_ablate.py [--out DIR] [VARIANT ...]

Variants (default: all): `base` (the engine as it is), `phase1` (return
after phase 1: tables, corner values), `phase2` (after phase 2: qp state,
primal densities), `phase3` (after phase 3: residual rows), `nodensity`
(phase 4 with the linearization's density replaced by a copy of its
inputs), `nocontract` (phase 4 without the contraction and its stores),
`nostore` (the contraction kept, its stores skipped), `tan1` / `tan4`
(kTan 1 or 4), `blocks2` / `blocks4` (kMinBlocks 2 or 4). Each variant
builds into DIR/<variant> (default tree_copies/ablate, listed in
.gitignore) with the flags of ops/_build.py, all nvcc at once; ptxas's
report goes to DIR/ptxas.txt. Prints one JSON line per (case, variant):
the median of 3 batches of 10 back-to-back launches (CUDA events) and the
largest difference of its outputs from `base`'s relative to max |base|
(the cut variants change them)."""

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

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from mrhyde_tpu_torch.ops import _build  # noqa: E402
from mrhyde_tpu_torch.ops import fused_ns as fn  # noqa: E402
from mrhyde_tpu_torch.ops import fused_set as fs  # noqa: E402
from mrhyde_tpu_torch.ops.fused_p1 import Stage  # noqa: E402

CSRC = os.path.join(REPO, "mrhyde_tpu_torch", "ops", "csrc")
ENGINE = "elem_engine.cuh"
# variant -> [(text of the engine, its replacement)]
_RETURN = "  __syncthreads();\n  if (Q > 0) return;\n"
VARIANTS = {
    "base": [],
    "phase1": [("  __syncthreads();\n\n  // phase 2:",
                _RETURN + "  // phase 2:")],
    "phase2": [("  __syncthreads();\n\n  // phase 3:",
                _RETURN + "  // phase 3:")],
    "phase3": [("  if constexpr (!LIN) {\n    if (a.n_tiles > 0)",
                "  if (Q > 0) return;\n  if constexpr (!LIN) {\n"
                "    if (a.n_tiles > 0)")],
    "nodensity": [("    Dens::template at<TR>(u, ud, g, pt, a, out);\n"
                   "    T* dq",
                   "    for (int o = 0; o < NO; ++o) {\n"
                   "      out[o].v = u[o % NV].v;\n"
                   "      for (int j = 0; j < kTan; ++j)\n"
                   "        out[o].d[j] = u[o % NV].d[j] + g[0][0].v;\n"
                   "    }\n    T* dq")],
    "nocontract": [("    if (busy) {\n      T J[NC][S];",
                    "    if (busy && Q < 0) {\n      T J[NC][S];")],
    "nostore": [("            if (pos >= 0) jac[(long long)pos * geo.E + ce]"
                 " = J[c][j];",
                 "            if (pos >= 0 && J[c][j] == T(1.2345e30))\n"
                 "              jac[(long long)pos * geo.E + ce] = J[c][j];")],
    "tan1": [("constexpr int kTan = 2;", "constexpr int kTan = 1;")],
    "tan4": [("constexpr int kTan = 2;", "constexpr int kTan = 4;")],
    "blocks2": [("constexpr int kMinBlocks = 3;",
                 "constexpr int kMinBlocks = 2;")],
    "blocks4": [("constexpr int kMinBlocks = 3;",
                 "constexpr int kMinBlocks = 4;")],
}
SET_CASES = ("ns+thermal pspg steady", "ns+cdr pspg+supg dirk22 stage 1",
             "ns+thermal advected pspg+supg dirk22 stage 1",
             "ns viscosity 1 + 0.1 ux^2 pspg steady",
             "thermal+cdr kappa = 1 + e*c steady",
             "cdr velocity (c, 1, 0.5) steady")


def patched(out, name):
    """A copy of csrc/ with the variant's patches, in out/name."""
    d = os.path.join(out, name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    path = os.path.join(d, ENGINE)
    text = open(path).read()
    for old, new in VARIANTS[name]:
        if old not in text:
            raise SystemExit(f"{name}: the engine no longer holds {old!r}")
        text = text.replace(old, new)
    open(path, "w").write(text)
    return d


def cases(dev):
    """[(label, 'ns' or the generated source, (ElemArgs, res, jac,
    keep-alive), the wrapper's inputs)] of phases 3e and 3g, f64."""
    f64 = torch.float64
    out = []
    for mesh, dims in cs.NS_ELEM_SHAPES[::2]:
        gen = torch.Generator(device=dev).manual_seed(8642)
        tab, lat, h, ue, ud, visc = cs.ns_elem_inputs(mesh, dims, dev, f64,
                                                      gen)
        src = (1.0,) + (0.0,) * (tab.dim - 1)
        for stage in (False, True):
            form = fn.NSForm(True, stage, h, 0.01 if stage else 1.0, stage)
            args = (ue, ud if stage else None, (1.0, 1.0, *src), tab, lat,
                    form, cs.ns_rows(True, stage, stage, False, mesh),
                    Stage(*cs.NS_STAGE1, None) if stage else None)
            out.append((f"ns_elem_full {mesh} "
                        f"{'stage' if stage else 'steady'}", "ns",
                        fn._ns_elem_args(*args), args))
    for name in SET_CASES:
        mesh, _b, box, _al, _dt = cs.SET_ELEM_KERNEL_CASES[name]
        dims = cs.SET_ELEM_SHAPES[mesh][0]
        gen = torch.Generator(device=dev).manual_seed(2468)
        tab, lat, q_off = cs.elem_tables(mesh, dims, dev, f64, box)
        form, sc, jac_idx, stage = cs.set_elem_case(
            name, math.fsum(tab.wts) ** (1.0 / tab.dim))
        geo = ((0.0,) * tab.dim, tuple(b / n for b, n in zip(box, dims)),
               q_off)
        ue, ud = cs.set_inputs(len(form.variables), dims, lat, dev, f64,
                               gen, stage)
        args = (form, ue, ud, sc, tab, lat, geo, jac_idx, stage)
        out.append((f"set_elem_full {name} ({mesh})", form.source,
                    fs._elem_args(*args), args))
    return out


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=os.path.join(REPO, "tree_copies",
                                                 "ablate"))
    p.add_argument("variants", nargs="*", default=list(VARIANTS))
    opts = p.parse_args()
    names = ["base"] + [v for v in opts.variants if v != "base"]
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    todo = cases(dev)
    nvcc = _build._nvcc()
    texts = sorted({key for _l, key, _a, _i in todo if key != "ns"})
    jobs = {}
    for name in names:
        d = patched(opts.out, name)
        srcs = {"ns": os.path.join(d, "fused_elem_ns.cu")}
        for i, text in enumerate(texts):
            srcs[text] = os.path.join(d, f"gen{i}.cu")
            open(srcs[text], "w").write(text)
        for key, src in srcs.items():
            lib = src[:-3] + ".so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", d, "-o", lib, src]
            jobs[name, key] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    with open(os.path.join(opts.out, "ptxas.txt"), "w") as log:
        for (name, key), (lib, proc) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {name}:\n{text[-3000:]}")
            log.write(f"==== {name} {'ns' if key == 'ns' else key[:40]}\n"
                      f"{text}\n")
            libs[name, key] = ctypes.CDLL(lib)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for label, key, (a, res, jac, _keep), _inputs in todo:
        base = None
        for name in names:
            fnc = getattr(libs[name, key], "ns_elem_full_f64" if key == "ns"
                          else "set_elem_full_f64")
            fnc.argtypes = [ctypes.c_void_p, ctypes.c_void_p]

            def call():
                err = fnc(ctypes.addressof(a), stream)
                if err:
                    raise SystemExit(f"{name} {label}: launch error {err}")
            res.zero_()
            jac.zero_()
            call()
            torch.cuda.synchronize()
            outs = (res.clone(), jac.clone())
            base = base or outs
            diff = max(float((o - b).abs().max()) /
                       max(float(b.abs().max()), 1e-300)
                       for o, b in zip(outs, base))
            times = []
            for _ in range(3):
                t0 = torch.cuda.Event(enable_timing=True)
                t1 = torch.cuda.Event(enable_timing=True)
                t0.record()
                for _ in range(10):
                    call()
                t1.record()
                t1.synchronize()
                times.append(t0.elapsed_time(t1) / 10)
            print(json.dumps({"case": label, "variant": name,
                              "ms": sorted(times)[1],
                              "rel_diff_from_base": diff}), flush=True)


if __name__ == "__main__":
    main()
