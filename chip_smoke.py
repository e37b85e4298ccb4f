"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives mrhyde_tpu_torch's steady thermal main path through
`Problem(cfg).run()` on the card, after building its CUDA kernels from
the sources in this checkout and holding each against its plain torch
version. Phases (one JSON line each):

  1 device   card name and power limit; exits non-zero without CUDA
  2 build    nvcc build of mrhyde_tpu_torch/ops/csrc/*.cu, in seconds
  3 kernels  thermal_node_state (kappa scalar, kappa = 1 + 0.5 x y) and
             thermal_node_full (kappa = 1 + e*e, seeded random u)
             against their plain versions at 1024x1024 and 1000x777, in
             f64 (max |diff| <= 1e-12 max|plain|) and f32 (<= 1e-5
             max|plain|), with the median of 20 CUDA-event timings each
  4 gold     kappa = 1, NX=NY=40, direct solve: L2(e) = 0.00102776
             (rtol 2e-5; the reference deck's gold)
  5 default  kappa = 1, NX=NY=1024, nonlinear TOL 1e-10, default solver
             (GMRES + Jacobi): L2(e) = 1.56873e-06 (rtol 1e-4)
  6 nonlin   kappa = 1 + e*e with its manufactured source, NX=NY=512,
             CG, nonlinear TOL 1e-10: L2(e) = 6.27492e-06 (rtol 1e-4)

The reference L2 values are the JAX package's, computed in f64 on the
CPU (the errors follow h^2 to four digits from 40 to 1024). Kernel
launch counts are reset just before each deck's Problem.run() and read
just after it, before the assembly timing: phases 4 and 5 must launch
thermal_node_state and phase 6 thermal_node_full, and the `kernels`
line reports the sums over the three runs. Any failure raises; the last
line of a passing run is {"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import torch


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


S_TRUE = "sin(2*pi*x)*sin(2*pi*y)"
SOURCE = "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"
# the source of kappa = 1 + u^2 for the same true solution
SOURCE_NL = (f"8*(pi*pi)*{S_TRUE}*(1+({S_TRUE})^2) - 8*(pi*pi)*{S_TRUE}*"
             "((cos(2*pi*x)*sin(2*pi*y))^2+(sin(2*pi*x)*cos(2*pi*y))^2)")


def deck(n, kappa="1.0", source=SOURCE, solver=None):
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": source, "thermal diffusion": kappa},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {"e": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": S_TRUE}},
    }


def quad_tables(N0, N1, device, dtype):
    """Reference-quad tables of a uniform N0 x N1 grid on the unit
    square, and the quadrature-point offsets inside an element."""
    import numpy as np
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    disc = Discretization(box_mesh("quad", nx=1, ny=1, xmax=1.0 / N0,
                                   ymax=1.0 / N1), [("e", "HGRAD", 1)], 2)
    key = ("HGRAD", 1)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], device, dtype)
    return tab, np.asarray(disc.ip[0])


def qp_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded random node grid u, and per-qp (E, Q) tensors: kappa =
    1 + 0.5 x y, and for kappa = 1 + e*e with source SOURCE_NL the
    tensors S, dS/de, K, dK/de at u."""
    import math
    u = torch.rand((N0 + 1, N1 + 1), generator=gen, device=device,
                   dtype=dtype) - 0.5
    ii = torch.arange(N0, device=device, dtype=dtype)[:, None, None]
    jj = torch.arange(N1, device=device, dtype=dtype)[None, :, None]
    qx = torch.as_tensor(q_off[:, 0], device=device, dtype=dtype)
    qy = torch.as_tensor(q_off[:, 1], device=device, dtype=dtype)
    x = (ii / N0 + qx).expand(N0, N1, tab.Q)
    y = (jj / N1 + qy).expand(N0, N1, tab.Q)
    kxy = (1.0 + 0.5 * x * y).reshape(-1, tab.Q).contiguous()
    corners = [u[:N0, :N1], u[1:, :N1], u[1:, 1:], u[:N0, 1:]]
    uq = torch.stack([sum(tab.phi[c][q] * corners[c] for c in range(4))
                      for q in range(tab.Q)], dim=-1)
    s = torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gx = torch.cos(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gy = torch.sin(2 * math.pi * x) * torch.cos(2 * math.pi * y)
    f = 8 * math.pi ** 2 * s * (1 + s * s) - 8 * math.pi ** 2 * s * (
        gx * gx + gy * gy)
    flat = [t.reshape(-1, tab.Q).contiguous()
            for t in (-f, torch.zeros_like(uq), 1.0 + uq * uq, 2.0 * uq)]
    return u, kxy, flat


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn(), after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_err(out, ref):
    """(max |out - ref|, max |ref|) over a tensor or a tuple of them."""
    if isinstance(ref, tuple):
        pairs = [max_err(o, r) for o, r in zip(out, ref)]
        return max(p[0] for p in pairs), max(p[1] for p in pairs)
    return (float((out - ref).abs().max()), float(ref.abs().max()))


KERNEL_SHAPES = ((1024, 1024), (1000, 777))


def phase_kernels(device):
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for N0, N1 in KERNEL_SHAPES:
            gen = torch.Generator(device=device).manual_seed(1234)
            tab, ip0 = quad_tables(N0, N1, device, dtype)
            u, kxy, (S, dS, K, dK) = qp_inputs(N0, N1, tab, ip0, device,
                                               dtype, gen)
            cases = [
                ("thermal_node_state", "kappa=1.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab)),
                ("thermal_node_state", "kappa=1+0.5xy",
                 lambda: fp.thermal_node_state(u, kxy, tab),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab)),
                ("thermal_node_full", "kappa=1+e*e",
                 lambda: fp.thermal_node_full(u, S, dS, K, dK, tab),
                 lambda: fp.thermal_node_full_plain(u, S, dS, K, dK, tab)),
            ]
            for name, label, kern, plain in cases:
                out, ref = kern(), plain()
                torch.cuda.synchronize()
                err, scale = max_err(out, ref)
                ok = err <= rtol * scale
                rec = {"phase": "kernels", "kernel": name, "case": label,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": [N0, N1], "max_abs_err": err,
                       "max_abs_plain": scale, "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(kern), "plain_ms": cuda_ms(plain)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                # the summary line quotes the f64 1024x1024 cases the main
                # path runs (the varying-kappa case for the state kernel)
                if dtype == torch.float64 and (N0, N1) == KERNEL_SHAPES[0] \
                        and label != "kappa=1.0":
                    summary[name] = rec
    return summary


def run_deck(name, cfg, device, want, rtol, mode):
    """Runs one deck through Problem(cfg).run() and checks its L2 error.
    The kernel launch counts are reset just before run() and read just
    after it, so they hold the main path's launches alone; the deck must
    have launched the `mode` kernel."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = Problem(cfg, device=device)
    t1 = time.perf_counter()
    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0
    result = problem.run()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(fp.LAUNCHES)
    l2 = result.errors[("L2", "e")]
    nr = result.newton
    u = result.u
    # one assembly (residual + Jacobian) at the solution, median of 5
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    tc = TimeCoeffs.steady(problem.n_dof, dtype=u.dtype, device=u.device)
    asm_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        problem.assembler.res_and_jac(u, tc)
        torch.cuda.synchronize()
        asm_ms.append((time.perf_counter() - ta) * 1e3)
    ok = (abs(l2 - want) <= rtol * abs(want)
          and u.shape == (problem.n_dof,) and bool(torch.isfinite(u).all())
          and u.device.type == torch.device(device).type)
    rec = {"phase": name, "n_dof": problem.n_dof,
           "linear_method": problem._linear_method(), "L2_e": l2,
           "L2_e_ref": want, "rtol": rtol, "newton_iters": nr.iterations,
           "newton_converged": nr.converged,
           "linear_iters": nr.linear_iters,
           "setup_s": t1 - t0, "solve_s": t2 - t1, "wall_s": t2 - t0,
           "assembly_ms": statistics.median(asm_ms),
           "launches": launches, "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit(f"phase {name} failed: {rec}")
    if launches[mode] <= 0:
        raise SystemExit(f"phase {name}: Problem.run() never launched the "
                         f"{mode!r} kernel: {launches}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    t0 = time.perf_counter()
    _build.load_library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": [ln for ln in _build.build_log().splitlines()
                    if "registers" in ln or "spill" in ln]})

    summary = phase_kernels(device)

    per_deck = [
        run_deck("gold_nx40", deck(40), device, 0.00102776, 2e-5, "state"),
        run_deck("default_nx1024",
                 deck(1024, solver={"nonlinear TOL": 1e-10}),
                 device, 1.56873e-06, 1e-4, "state"),
        run_deck("nonlinear_nx512",
                 deck(512, "1.0 + e*e", SOURCE_NL,
                      {"nonlinear TOL": 1e-10, "Belos solver": "CG"}),
                 device, 6.27492e-06, 1e-4, "full"),
    ]
    launches = {k: sum(d[k] for d in per_deck) for k in fp.LAUNCHES}
    emit({"phase": "launches", **launches})
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")

    src = "mrhyde_tpu_torch/ops/csrc/fused_p1_thermal.cu"
    kernels = []
    for name, mode in (("thermal_node_state", "state"),
                       ("thermal_node_full", "full")):
        rec = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": "mrhyde_tpu/ops/fused_p1.py:1350",
                        "launches": launches[mode],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"]})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
