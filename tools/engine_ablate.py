"""Where the time of the element-tile engine and of the affine sets'
state kernel goes, on one card: builds patched copies of a tree's csrc/,
each with a part of a kernel cut or a constant changed, and times each
through its C entry point on the cases of chip_smoke.py's phases 3e and
3g (the engine: ns_elem_full and set_elem_full, f64, the divisible
shapes) and 3h (set_elem_state on hex and p2, f64 and f32, both
shapes).

    python tools/engine_ablate.py [--csrc DIR] [--kinds K,...] [--out DIR]
                                  [--ptx] [VARIANT ...]

`--ptx` instead reports, for each kernel of phase 3h's hex and p2
generated sources, whether its PTX evaluates a sin or a cos (`ptx_trig`).
`--csrc` (default: this tree's) is the csrc/ directory to build, such as
that of an unpacked `git archive` of an earlier commit; another tree's
kernels are timed as they are (`base` only: the patches match this
tree's sources; `--kinds` chooses its kernels). Variants (default: all,
or `base` alone with `--kinds`) are listed in VARIANTS: `base` (the
kernels as they are, timed on the cases the chosen variants cut); on the
engine `phase1` (return after phase 1: tables, corner values), `phase2`
(after phase 2: qp state, primal densities), `phase3` (after phase 3:
residual rows), `nodensity` (phase 4 with the linearization's density
replaced by a copy of its inputs), `nocontract` (phase 4 without the
contraction and its stores), `nostore` (the contraction kept, its stores
skipped), `tan1` / `tan4` (kTan 1 or 4), `blocks2` / `blocks4`
(kMinBlocks 2 or 4); on set_elem_state the variants named `state_*`.
Each variant builds into DIR/<tree>/<variant> (default
tree_copies/ablate, listed in .gitignore; <tree> is `current`, or
`other` for another tree's csrc/) with the flags of ops/_build.py, all
nvcc at once; ptxas's report goes to DIR/<tree>/ptxas.txt. Prints one
JSON line per (case, variant): the median of 3 batches of 10
back-to-back launches (CUDA events; set_elem_state: `ms` the median of 5
batches of 20 and `single_ms` the median of 20 single launches, with the
default `--csrc` the Python wrapper's `wrapper_ms` and
`wrapper_single_ms` beside `base`, as tools/node_ablate.py times them,
and beside `base` its bound, chip_smoke.py's `state_work` and `bound`,
and `share`, the bound over `ms`) and the largest difference of its
outputs from `base`'s relative to max |base| (the cut variants change
them)."""

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
ENGINE, SET_ELEM = "elem_engine.cuh", "set_elem.cuh"
_RETURN = "  __syncthreads();\n  if (Q > 0) return;\n"
# variant -> [(file, text of the file, its replacement)]: the engine's
# (on ns_elem_full and set_elem_full), then set_elem_state's
VARIANTS = {
    "base": [],
    "phase1": [(ENGINE, "  __syncthreads();\n\n  // phase 2:",
                _RETURN + "  // phase 2:")],
    "phase2": [(ENGINE, "  __syncthreads();\n\n  // phase 3:",
                _RETURN + "  // phase 3:")],
    "phase3": [(ENGINE, "  if (a.n_tiles > 0)  // the same in every thread",
                "  if (Q > 0) return;\n  if (a.n_tiles > 0)  // the same in "
                "every thread")],
    "nodensity": [(ENGINE, "    Dens::template at<TR>(u, ud, g, pt, a, out);\n"
                   "    T* dq",
                   "    for (int o = 0; o < NO; ++o) {\n"
                   "      out[o].v = u[o % NV].v;\n"
                   "      for (int j = 0; j < kTan; ++j)\n"
                   "        out[o].d[j] = u[o % NV].d[j] + g[0][0].v;\n"
                   "    }\n    T* dq")],
    "nocontract": [(ENGINE, "    if (busy) {\n      T J[NC][S];",
                    "    if (busy && Q < 0) {\n      T J[NC][S];")],
    "nostore": [(ENGINE, "            if (pos >= 0) jac[(long long)pos * "
                 "geo.E + ce] = J[c][j];",
                 "            if (pos >= 0 && J[c][j] == T(1.2345e30))\n"
                 "              jac[(long long)pos * geo.E + ce] = J[c][j];")],
    "tan1": [(ENGINE, "constexpr int kTan = 2;", "constexpr int kTan = 1;")],
    "tan4": [(ENGINE, "constexpr int kTan = 2;", "constexpr int kTan = 4;")],
    "blocks2": [(ENGINE, "constexpr int kMinBlocks = 3;",
                 "constexpr int kMinBlocks = 2;")],
    "blocks4": [(ENGINE, "constexpr int kMinBlocks = 3;",
                 "constexpr int kMinBlocks = 4;")],
    # set_elem_state: the tables, the corner gathers and the row
    # stores only (no qp)
    "state_loads_stores": [
        (SET_ELEM, "    for (int q = 0; q < Q; ++q) {\n      const T* t = "
         "tb + q * L::PQ;",
         "    for (int q = 0; q < 0; ++q) {\n      const T* t = tb + q * "
         "L::PQ;"),
        (SET_ELEM, "res[(long long)(v * NC + c) * geo.E + e] =\n"
         "          r[v][c];", "res[(long long)(v * NC + c) * geo.E + e] ="
         "\n          r[v][c] + uc[v][c];")],
    # the tangent-only density pass replaced by a copy of its inputs
    "state_no_density": [(
        SET_ELEM, "      Dens::template at<TR>(zu, zud, zg, pt, a, zo);",
        "#pragma unroll\n      for (int k = 0; k < NO; ++k)\n"
        "        zo[k] = k < NV ? zu[k] : zg[(k - NV) / DIM][(k - NV) % "
        "DIM];")],
    # blocks per SM for the registers: 3 (168) or 4 (128) instead of 2
    "state_min3": [(SET_ELEM, "constexpr int kElemStateMinBlocks = 2;",
                    "constexpr int kElemStateMinBlocks = 3;")],
    "state_min4": [(SET_ELEM, "constexpr int kElemStateMinBlocks = 2;",
                    "constexpr int kElemStateMinBlocks = 4;")],
}
# (label, dtype) -> chip_smoke.bound of a set_elem_state case
BOUNDS = {}
SET_CASES = ("ns+thermal pspg steady", "ns+cdr pspg+supg dirk22 stage 1",
             "ns+thermal advected pspg+supg dirk22 stage 1",
             "ns viscosity 1 + 0.1 ux^2 pspg steady",
             "thermal+cdr kappa = 1 + e*c steady",
             "cdr velocity (c, 1, 0.5) steady")


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


def ptx_trig(texts, csrc, out):
    """{(source index, kernel): whether it evaluates a sin or a cos}: each
    generated source compiled to PTX (nvcc -ptx, ops/_build.py's
    architecture) against csrc, and each kernel entry, with the functions
    it calls, searched for the argument reduction tables of sin and cos
    (`__cudart_i2opi_d`, `__cudart_i2opi_f`), which every sin or cos
    reads on its slow path. The decks' sources use sin and cos only in
    their source terms, which a state kernel's tangent-only pass must
    never evaluate (the full kernels' primal densities must)."""
    import re
    nvcc = _build._nvcc()
    os.makedirs(out, exist_ok=True)
    found = {}
    for i, text in enumerate(texts):
        src, ptx = os.path.join(out, f"ptx{i}.cu"), os.path.join(out,
                                                             f"ptx{i}.ptx")
        open(src, "w").write(text)
        subprocess.run([nvcc, "-arch=sm_90a", "-std=c++17", "-O3", "-ptx",
                        "-I", csrc, "-o", ptx, src], check=True,
                       capture_output=True)
        body = open(ptx).read()
        heads = list(re.finditer(r"^\.(?:visible |weak )?\.?(entry|func)"
                                 r"\s+(?:\([^)]*\)\s*)?(\w+)", body, re.M))
        blocks = {}
        for k, m in enumerate(heads):
            end = heads[k + 1].start() if k + 1 < len(heads) else len(body)
            blocks[m.group(2)] = (m.group(1), body[m.start():end])

        def trig(name, seen):
            if name in seen or name not in blocks:
                return False
            seen.add(name)
            code = blocks[name][1]
            return "__cudart_i2opi" in code or any(
                trig(c, seen) for c in re.findall(r"call(?:\.uni)?\s+"
                                                  r"(?:\([^)]*\),\s*)?(\w+)",
                                                  code))
        for name, (kind, _code) in blocks.items():
            if kind == "entry":
                kernel = re.search(r"(set_\w+?_kernel|elem_full_kernel)",
                                   name)
                found[i, kernel.group(1) if kernel else name, name] = trig(
                    name, set())
    return found


def _runs(variant, kind, kinds):
    """Whether a variant runs on a case of this kind ('full': the engine,
    'state': set_elem_state): `base` on the kinds the chosen variants
    cut, `state_*` on set_elem_state, the others on the engine."""
    if variant == "base":
        return kind in kinds
    return ("state" if variant.startswith("state_") else "full") == kind


def cases(dev):
    """[(dtype, label, 'full', 'ns' or the generated source, ElemArgs,
    outputs, keep-alive, wrapper call)] of phases 3e and 3g, f64."""
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
            a, res, jac, keep = fn._ns_elem_args(*args)
            out.append((f64, f"ns_elem_full {mesh} "
                        f"{'stage' if stage else 'steady'}", "full", "ns", a,
                        (res, jac), keep, None))
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
        a, res, jac, keep = fs._elem_args(*args)
        out.append((f64, f"set_elem_full {name} ({mesh})", "full",
                    form.source, a, (res, jac), keep, None))
    return out


def state_cases(dev, dtype):
    """The same of set_elem_state: phase 3h's hex and p2 cases at both
    their shapes (hex 64^3 and 31x23x15, p2 512^2 and 250x161)."""
    out = []
    for (name, (mesh, _b, box, _al, _dt)), i in (
            (c, i) for c in cs.STATE_KERNEL_CASES.items() for i in (0, 1)):
        if mesh == "p1":
            continue
        dims = cs.STATE_SHAPES[mesh][i]
        gen = torch.Generator(device=dev).manual_seed(1357)
        tab, lat, q_off = cs.elem_tables(mesh, dims, dev, dtype, box)
        form, sc, stage = cs.state_case(
            name, math.fsum(tab.wts) ** (1.0 / tab.dim))
        geo = ((0.0,) * tab.dim, tuple(b / n for b, n in zip(box, dims)),
               q_off)
        u, _ = cs.set_inputs(len(form.variables), dims, lat, dev, dtype,
                             gen, None)
        args = (form, u, sc, tab, lat, geo, stage)
        a, res, _jac, keep = fs._elem_args(form, u, None, sc, tab, lat, geo,
                                           (), stage, lin=True)
        label = f"set_elem_state {name} ({mesh} {'x'.join(map(str, dims))})"
        BOUNDS[label, dtype] = cs.bound(*cs.state_work(
            dims, dtype, form, u, sc, tab, lat, stage, False), dtype)
        out.append((dtype, label, "state", form.source, a, (res,),
                    (keep, u, tab), lambda x=args: fs.set_elem_state(*x)))
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
                   "full,state (default: those the named variants cut; "
                   "all where none is named)")
    p.add_argument("--out", default=os.path.join(REPO, "tree_copies",
                                                 "ablate"))
    p.add_argument("--ptx", action="store_true",
                   help="only report which kernels of phase 3h's hex and "
                   "p2 sources evaluate a sin or a cos (ptx_trig)")
    p.add_argument("variants", nargs="*")
    opts = p.parse_args()
    if opts.ptx:
        dev = torch.device("cuda", 0)
        texts = sorted({c[3] for c in state_cases(dev, torch.float64)})
        for (i, kernel, name), hit in ptx_trig(
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
        "state" if v.startswith("state_") else "full" for v in names
        if v != "base"} or {"full", "state"}
    out_dir = os.path.join(opts.out, "current" if own else "other")
    os.makedirs(out_dir, exist_ok=True)
    print(cs.nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    todo = cases(dev) if "full" in kinds else []
    if "state" in kinds:
        for dtype in (torch.float64, torch.float32):
            todo += state_cases(dev, dtype)
    nvcc = _build._nvcc()
    keys = sorted({(kind, key) for _d, _l, kind, key, *_r in todo})
    texts = sorted({key for _k, key in keys if key != "ns"})
    jobs = {}
    for name in names:
        d = patched(opts.csrc, out_dir, name, VARIANTS[name])
        srcs = {"ns": os.path.join(d, "fused_elem_ns.cu")}
        for i, text in enumerate(texts):
            srcs[text] = os.path.join(d, f"gen{i}.cu")
            open(srcs[text], "w").write(text)
        for key, src in srcs.items():
            if not any(_runs(name, k, kinds) for k, t in keys if t == key):
                continue
            lib = src[:-3] + ".so"
            cmd = [nvcc, *_build.NVCC_FLAGS, "-I", d, "-o", lib, src]
            jobs[name, key] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    if own and "state" in kinds:
        _build.load_library()
    libs = {}
    with open(os.path.join(out_dir, "ptxas.txt"), "w") as log:
        for (name, key), (lib, proc) in jobs.items():
            text, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"nvcc failed on {name}:\n{text[-3000:]}")
            log.write(f"==== {name} {'ns' if key == 'ns' else key[:40]}\n"
                      f"{text}\n")
            libs[name, key] = ctypes.CDLL(lib)
    stream = ctypes.c_void_p(torch.cuda.current_stream(dev).cuda_stream)
    for dtype, label, kind, key, a, outs, _keep, wrapper in todo:
        suffix = "f64" if dtype == torch.float64 else "f32"
        base = None
        for name in names:
            if not _runs(name, kind, kinds):
                continue
            entry = {"full": "ns_elem_full_" if key == "ns"
                     else "set_elem_full_",
                     "state": "set_elem_state_"}[kind] + suffix
            fnc = getattr(libs[name, key], entry)
            fnc.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
            fnc.restype = ctypes.c_int

            def call():
                err = fnc(ctypes.addressof(a), stream)
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
                   "rel_diff_from_base": diff}
            if kind == "state":
                rec.update(ms=batched(call), single_ms=cs.cuda_ms(call))
                if name == "base" and own:
                    rec["wrapper_ms"] = batched(wrapper)
                    rec["wrapper_single_ms"] = cs.cuda_ms(wrapper)
                if name == "base":
                    rec.update(BOUNDS[label, dtype])
                    rec["share"] = rec["bound_ms"] / rec["ms"]
            else:
                rec["ms"] = batched(call, 10, 3)
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
