"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives mrhyde_tpu_torch's thermal main path, steady and transient,
through `Problem(cfg).run()` on the card, after building its CUDA
kernels from the sources in this checkout and holding each against its
plain torch version. Phases (one JSON line each):

  1 device   card name and power limit; exits non-zero without CUDA
  2 build    nvcc build of mrhyde_tpu_torch/ops/csrc/*.cu, in seconds
  3 kernels  against their plain versions at 1024x1024 and 1000x777, in
             f64 (max |diff| <= 1e-12 max|plain|) and f32 (<= 1e-5
             max|plain|), with the median of 20 CUDA-event timings each:
             thermal_node_state steady (kappa scalar, kappa = 1 + 0.5 x
             y) and transient at DIRK-2,2 stage-1 coefficients (alpha_u
             = 0.5, alpha_t = 40; m = 2 with kappa = 1, m = 1 + 0.5 x
             with kappa = 1 + 0.5 x y); thermal_node_full steady and
             transient (kappa = 1 + e*e; seeded random u, beta_u, beta_t)
  4 gold     kappa = 1, NX=NY=40, direct solve: L2(e) = 0.00102776
             (rtol 2e-5; the reference deck's gold)
  5 default  kappa = 1, NX=NY=1024, nonlinear TOL 1e-10, default solver
             (GMRES + Jacobi): L2(e) = 1.56873e-06 (rtol 1e-4)
  6 nonlin   kappa = 1 + e*e with its manufactured source, NX=NY=512,
             CG, nonlinear TOL 1e-10: L2(e) = 6.27492e-06 (rtol 1e-4)
  7 transient_gold_nx40   the reference's 2D transient deck: NX=NY=40,
             BWE, 20 steps to t=1, direct: L2(e) = 0.00509256 at t=0.9
             and 0.00118468 at t=1.0 (rtol 2e-5; the reference's gold)
  8 transient_dirk22      the same manufactured deck at NX=NY=DIRK_N (512),
             DIRK-2,2, 8 steps to t=0.4, nonlinear TOL 1e-10, default
             solver (GMRES + Jacobi): L2(e) at t=0.4 (rtol 1e-4)
  9 transient_nonlinear_bdf2_nx512   kappa = 1 + e*e with its
             manufactured transient source, CG, nonlinear TOL 1e-10,
             BDF2 after one BWE/BDF1 startup step, 4 steps to t=0.2:
             L2(e) at t=0.2 (rtol 1e-4)
 10 ode_bdf2 the ODE BDF2 deck of tests/test_ode_integrators.py (general
             path, HVOL): L2(q) = 0.00106624 at t=1.0 (rtol 2e-5)

The reference L2 values are the JAX package's, computed in f64 on the
CPU, or the reference's golds. Each deck runs one assembly before its
solve timer (reported as warmup_s). Kernel launch counts are reset just
before each deck's Problem.run() and read just after it, before the
assembly timing; so are the calls of the assembler's fused provider. A
fused deck must launch its kernel exactly once per fused res_and_jac
call (each Newton iteration and each stage's converged check), plus,
for the state kernel in a transient deck, twice per stage (the coord
part on the beta_u and beta_t grids), and the other kernel never: phases
4, 5, 7 and 8 run thermal_node_state, 6 and 9 thermal_node_full. The
`kernels` line reports the sums over the decks.
Any failure raises; the last line of a passing run is {"ok": true,
"device": {...}}.
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
# transient: u = T S with T = sin(2 pi t), S = S_TRUE
T_TIME = "sin(2*pi*t)"
SOURCE_T = ("(8*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))"
            "*sin(2*pi*x)*sin(2*pi*y)")
# u_t - div((1 + u^2) grad u) for the same u, S and T substituted as text
SOURCE_T_NL = (
    "2*pi*cos(2*pi*t)*S + 8*(pi*pi)*T*S*(1+(T*S)^2) - 8*(pi*pi)*T*T*T*S*"
    "((cos(2*pi*x)*sin(2*pi*y))^2+(sin(2*pi*x)*cos(2*pi*y))^2)"
).replace("S", S_TRUE).replace("T", T_TIME)
# mesh of the DIRK-2,2 deck, and the JAX package's f64 CPU L2(e) at t=0.4
# (512², not 1024²: the JAX CPU run that gives the reference takes 6.4
# minutes at 512² and grows ~10x per halving of h)
DIRK_N, DIRK_L2 = 512, 0.000966998
# the JAX package's f64 CPU L2(e) at t=0.2 of the nonlinear BDF2 deck
# (its error falls 4x per halving of h and dt: 2.01e-3, 4.80e-4, 1.17e-4
# at 32², 64², 128² with 4, 8, 16 steps)
BDF2_NL_L2 = 0.000532754


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


def transient_deck(n, solver, kappa="1.0", source=SOURCE_T):
    """The reference's 2D transient thermal deck (IC 0, Dirichlet 0,
    u = sin(2 pi t) S_TRUE) with the given transient Solver keys."""
    cfg = deck(n, kappa, source, dict({"solver": "transient"}, **solver))
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"e": f"{T_TIME}*{S_TRUE}"}
    return cfg


def nonlinear_deck(n):
    """kappa = 1 + e*e with its manufactured source, CG."""
    return deck(n, "1.0 + e*e", SOURCE_NL,
                {"nonlinear TOL": 1e-10, "Belos solver": "CG"})


def bdf2_nonlinear_deck(n):
    """kappa = 1 + e*e with its manufactured transient source, CG, BDF2
    after one BWE/BDF1 startup step, 4 steps to t=0.2."""
    return transient_deck(n, {
        "transient Butcher tableau": "BWE", "transient BDF order": 2,
        "transient startup Butcher tableau": "BWE",
        "transient startup BDF order": 1, "transient startup steps": 1,
        "final time": 0.2, "number of steps": 4, "nonlinear TOL": 1e-10,
        "Belos solver": "CG"}, "1.0 + e*e", SOURCE_T_NL)


def ode_bdf2_deck():
    """tests/test_ode_integrators.py's BDF2 deck: q' = -q, q(0) = 1."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": 2, "NY": 2},
        "Functions": {"ODE source": "-1.0*q"},
        "Physics": {"modules": "ODE", "Initial conditions": {"q": "1.0"}},
        "Discretization": {"order": {"q": 1}, "quadrature": 1},
        "Solver": {"solver": "transient", "transient BDF order": 2,
                   "transient Butcher tableau": "BWE",
                   "transient startup Butcher tableau": "DIRK-1,2",
                   "transient startup BDF order": 1,
                   "transient startup steps": 2, "workset size": 1,
                   "nonlinear TOL": 1e-7, "max nonlinear iters": 2,
                   "final time": 1.0, "number of steps": 10,
                   "use direct solver": True},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"q": "1.0*exp(-1.0*t)"}},
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


# DIRK-2,2 stage 1 at dt = 0.05: alpha_u = A11/b1, alpha_t = 1/(dt b1)
DIRK22_STAGE1 = (0.5, 40.0)


def qp_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded random node grids u, beta_u, beta_t, and per-qp (E, Q)
    tensors: kappa = 1 + 0.5 x y, m = 1 + 0.5 x; for kappa = 1 + e*e
    with source SOURCE_NL the tensors S, dS/de, K, dK/de at u (steady),
    and at u_eval = alpha_u u + beta_u, u_dot = alpha_t u + beta_t with
    m = 1 (S = u_dot - f; DIRK-2,2 stage-1 alphas) for the transient
    full kernel. Returns (u, kxy, mx, steady full inputs, (u_eval,
    transient full inputs))."""
    import math
    u, bu, bt = (torch.rand((N0 + 1, N1 + 1), generator=gen, device=device,
                            dtype=dtype) - 0.5 for _ in range(3))
    ii = torch.arange(N0, device=device, dtype=dtype)[:, None, None]
    jj = torch.arange(N1, device=device, dtype=dtype)[None, :, None]
    qx = torch.as_tensor(q_off[:, 0], device=device, dtype=dtype)
    qy = torch.as_tensor(q_off[:, 1], device=device, dtype=dtype)
    x = (ii / N0 + qx).expand(N0, N1, tab.Q)
    y = (jj / N1 + qy).expand(N0, N1, tab.Q)
    kxy = (1.0 + 0.5 * x * y).reshape(-1, tab.Q).contiguous()
    mx = (1.0 + 0.5 * x).reshape(-1, tab.Q).contiguous()

    def at_qps(g):
        corners = [g[:N0, :N1], g[1:, :N1], g[1:, 1:], g[:N0, 1:]]
        return torch.stack([sum(tab.phi[c][q] * corners[c]
                                for c in range(4))
                            for q in range(tab.Q)], dim=-1)
    s = torch.sin(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gx = torch.cos(2 * math.pi * x) * torch.sin(2 * math.pi * y)
    gy = torch.sin(2 * math.pi * x) * torch.cos(2 * math.pi * y)
    f = 8 * math.pi ** 2 * s * (1 + s * s) - 8 * math.pi ** 2 * s * (
        gx * gx + gy * gy)

    def full_inputs(uq, S):
        return [t.reshape(-1, tab.Q).contiguous()
                for t in (S, torch.zeros_like(uq), 1.0 + uq * uq, 2.0 * uq)]
    au, at = DIRK22_STAGE1
    ue = (au * u + bu).contiguous()
    ueq, udq = at_qps(ue), at_qps(at * u + bt)
    return (u, kxy, mx, full_inputs(at_qps(u), -f),
            (ue, full_inputs(ueq, udq - f)))


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
            u, kxy, mx, (S, dS, K, dK), (ue, tr) = qp_inputs(
                N0, N1, tab, ip0, device, dtype, gen)
            st2 = fp.Stage(*DIRK22_STAGE1, 2.0)
            stx = fp.Stage(*DIRK22_STAGE1, mx)
            st1 = fp.Stage(*DIRK22_STAGE1, 1.0)
            cases = [
                ("thermal_node_state", "kappa=1.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab)),
                ("thermal_node_state", "kappa=1+0.5xy",
                 lambda: fp.thermal_node_state(u, kxy, tab),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab)),
                ("thermal_node_state", "dirk22 kappa=1.0 m=2.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab, st2),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab, st2)),
                ("thermal_node_state", "dirk22 kappa=1+0.5xy m=1+0.5x",
                 lambda: fp.thermal_node_state(u, kxy, tab, stx),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab, stx)),
                ("thermal_node_full", "kappa=1+e*e",
                 lambda: fp.thermal_node_full(u, S, dS, K, dK, tab),
                 lambda: fp.thermal_node_full_plain(u, S, dS, K, dK, tab)),
                ("thermal_node_full", "dirk22 kappa=1+e*e m=1.0",
                 lambda: fp.thermal_node_full(ue, *tr, tab, st1),
                 lambda: fp.thermal_node_full_plain(ue, *tr, tab, st1)),
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
                # the summary line quotes the f64 1024x1024 transient
                # cases (the varying-coefficient one for the state kernel)
                if dtype == torch.float64 and (N0, N1) == KERNEL_SHAPES[0] \
                        and label in ("dirk22 kappa=1+0.5xy m=1+0.5x",
                                      "dirk22 kappa=1+e*e m=1.0"):
                    summary[name] = rec
    return summary


def assembly_tc(problem, u, time):
    """The TimeCoeffs of one timed assembly at state u: a steady call, or
    for a transient deck a BWE stage of its step size seeded from u."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    sc = problem.solver_cfg
    if sc.get("solver") != "transient":
        return TimeCoeffs.steady(problem.n_dof, dtype=u.dtype,
                                 device=u.device)
    dt = float(sc["final time"]) / int(sc["number of steps"])
    return TimeCoeffs(1.0, torch.zeros_like(u), 1.0 / dt, -u / dt,
                      float(time), dt)


def run_deck(name, cfg, device, checks, mode):
    """Runs one deck through Problem(cfg).run() and checks its L2 errors:
    `checks` lists (time, var, reference, rtol). One assembly at the zero
    state runs before the timer (`warmup_s`, set-up: the first use of the
    CUDA path of torch.func.jvp and of the DSL), so a deck's solve time
    does not depend on its place in the run. The kernel launch counts
    and the fused provider's calls are reset just before run() and read
    just after it, so they hold the main path's alone. A fused deck
    (`mode` "state" or "full") must launch that kernel once per fused
    res_and_jac call, the state kernel twice more per stage of a
    transient deck (the beta grids of the coord part), and the other
    kernel never; mode None: no fused provider, no launch."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    from mrhyde_tpu_torch.problem import Problem
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    problem = Problem(cfg, device=device)
    asm = problem.assembler
    fused = asm.fused_provider()
    t1 = time.perf_counter()
    u0 = torch.zeros(problem.n_dof, dtype=problem.dtype, device=device)
    asm.res_and_jac(u0, assembly_tc(problem, u0, 0.0))
    torch.cuda.synchronize()
    if fused is not None:
        fused._stage_cache = None   # the warm-up leaves no coord part
    t2 = time.perf_counter()
    calls = [0]
    if fused is not None:
        jacobian = fused.jacobian

        def counted(*a, **k):
            calls[0] += 1
            return jacobian(*a, **k)
        fused.jacobian = counted
    for k in fp.LAUNCHES:
        fp.LAUNCHES[k] = 0
    result = problem.run()
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(fp.LAUNCHES)
    fused_calls = calls[0]
    hist = {round(t, 10): errs for t, errs in result.error_history}
    errors = [{"time": t, "var": v, "L2": hist[round(t, 10)][("L2", v)],
               "L2_ref": want, "rtol": rtol}
              for t, v, want, rtol in checks]
    u = result.u
    # one assembly (residual + Jacobian) at the solution, median of 5
    tc = assembly_tc(problem, u, result.time)
    asm_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        ta = time.perf_counter()
        asm.res_and_jac(u, tc)
        torch.cuda.synchronize()
        asm_ms.append((time.perf_counter() - ta) * 1e3)
    ok = (all(abs(e["L2"] - e["L2_ref"]) <= e["rtol"] * abs(e["L2_ref"])
              for e in errors)
          and u.shape == (problem.n_dof,) and bool(torch.isfinite(u).all())
          and u.device.type == torch.device(device).type)
    rec = {"phase": name, "n_dof": problem.n_dof,
           "linear_method": problem._linear_method(), "errors": errors,
           "recorded_times": len(result.error_history), **result.counts,
           "setup_s": t1 - t0, "warmup_s": t2 - t1, "solve_s": t3 - t2,
           "wall_s": t3 - t0, "assembly_ms": statistics.median(asm_ms),
           "fused_calls": fused_calls, "launches": launches, "ok": ok}
    emit(rec)
    if not ok:
        raise SystemExit(f"phase {name} failed: {rec}")
    if mode is None:
        want = {k: 0 for k in launches}
        if fused is not None:
            raise SystemExit(f"phase {name}: expected no fused provider")
    else:
        per_stage = 2 * result.counts["stages"] \
            if mode == "state" and problem.solver_cfg.get("solver") \
            == "transient" else 0
        want = {k: fused_calls + per_stage if k == mode else 0
                for k in launches}
    if launches != want or (mode is not None and fused_calls <= 0):
        raise SystemExit(f"phase {name}: Problem.run() launched {launches} "
                         f"for {fused_calls} fused res_and_jac calls and "
                         f"counts {result.counts}; expected {want}")
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
        run_deck("gold_nx40", deck(40), device,
                 [(0.0, "e", 0.00102776, 2e-5)], "state"),
        run_deck("default_nx1024",
                 deck(1024, solver={"nonlinear TOL": 1e-10}),
                 device, [(0.0, "e", 1.56873e-06, 1e-4)], "state"),
        run_deck("nonlinear_nx512", nonlinear_deck(512),
                 device, [(0.0, "e", 6.27492e-06, 1e-4)], "full"),
        run_deck("transient_gold_nx40",
                 transient_deck(40, {
                     "transient Butcher tableau": "BWE",
                     "transient BDF order": 1, "final time": 1.0,
                     "number of steps": 20, "nonlinear TOL": 1e-7,
                     "max nonlinear iters": 2}),
                 device, [(0.9, "e", 0.00509256, 2e-5),
                          (1.0, "e", 0.00118468, 2e-5)], "state"),
        run_deck(f"transient_dirk22_nx{DIRK_N}",
                 transient_deck(DIRK_N, {
                     "transient Butcher tableau": "DIRK-2,2",
                     "final time": 0.4, "number of steps": 8,
                     "nonlinear TOL": 1e-10}),
                 device, [(0.4, "e", DIRK_L2, 1e-4)], "state"),
        run_deck("transient_nonlinear_bdf2_nx512", bdf2_nonlinear_deck(512),
                 device, [(0.2, "e", BDF2_NL_L2, 1e-4)], "full"),
        run_deck("ode_bdf2", ode_bdf2_deck(), device,
                 [(1.0, "q", 0.00106624, 2e-5)], None),
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
