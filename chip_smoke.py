"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives mrhyde_tpu_torch's thermal, cdr, thermal-advection and
Navier-Stokes main paths (2D p1 quads, 3D hex, 2D p2 quads) and its
module sets (NS + thermal with the Boussinesq term, NS + cdr, thermal +
cdr, coefficients that read the state; 2D p1 quads, 3D hex, 2D p2
quads), steady and transient,
through
`Problem(cfg).run()` on the card, after building
its CUDA kernels from the sources in this checkout (one nvcc per source,
the deck-generated module-set kernels among them, all in parallel) and
holding each against its plain torch version. Phases (one JSON line
each):

  1 device   card name and power limit; exits non-zero without CUDA
  2 build    nvcc build of mrhyde_tpu_torch/ops/csrc/*.cu and of the
             set_node_full and set_elem_full sources generated for phases
             3f and 3g and decks 34-43 (functions/codegen.py), in
             seconds, with ptxas's report
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
 3b kernels  ns_node_full against its plain version at 1024x256 and
             1000x243 on the channel [0,5]x[0,1], f64 and f32 (the same
             bounds), residual and rows each: PSPG steady with viscosity 1
             and 0.1 + 0.01 x, PSPG+SUPG at DIRK-2,2 stage-1 alphas (0.5,
             200) with seeded u_dot; CUDA-event medians of 20 (plain: its
             one check call)
 11 ns_channel_gold_nx50   the reference's NS channel, 50x10, PSPG,
             direct: L2 ux/pr/uy = 0.00198075 / 0.0148536 / 0.000169464
             (rtol 2e-5; the reference's gold)
 12 ns_channel_direct_nx128   the same at 128x32, nonlinear TOL 1e-8,
             direct (12,771 DOFs): the JAX package's L2 (rtol 1e-4)
 13 ns_startup_dirk22_nx128, _nx256   the channel started from rest at
             128x32 (12,771 DOFs) and 256x64 (50,115), PSPG+SUPG,
             DIRK-2,2, 4 steps of 0.01, nonlinear TOL 1e-8, default solver
             (GMRES + Jacobi): the JAX package's L2 ux/pr/uy at t=0.02 and
             0.04 (rtol 1e-6: every stage's Newton solve converges)
 3c kernels  thermal_elem_state and thermal_elem_full (the element
             kernels) against their plain versions on hex at 128^3 and
             127x100x77 and on p2 quads at 1024^2 and 1000x777, f64 and
             f32 (the same bounds): steady with kappa = 1 and kappa = 1 +
             0.5 x y (z), and at DIRK-2,2 stage-1 alphas with m = 1 +
             0.5 x; "full" with kappa = 1 + e*e steady and at that stage
             (seeded u, beta_u, beta_t); CUDA-event medians of 20 (plain:
             its one check call)
 14 hex_gold_nx10   the reference's thermal/3D_verification, 10^3 hex,
             direct: L2(e) = 0.0116656 (rtol 2e-5; the reference's gold)
 15 hex_default_nx40   the same at 40^3 (68,921 DOFs; cut from 64^3, then
             48^3), nonlinear TOL 1e-10, GMRES + Jacobi (HEX_DECKS)
 16 hex_nonlinear_nx40   kappa = 1 + e*e with its manufactured source,
             40^3, CG, TOL 1e-10
 17 hex_transient_dirk22_nx40   u = sin(2 pi t) S3, IC 0, DIRK-2,2, 8
             steps to t=0.4, TOL 1e-10, GMRES + Jacobi
 18 hex_transient_nonlinear_bdf2_nx40   kappa = 1 + e*e, BDF2 after one
             BWE/BDF1 startup step, 4 steps to t=0.2, CG
 19 p2_default_nx256   p2 quads (quadrature 4), kappa = 1, 256^2
             (263,169 DOFs), TOL 1e-10, GMRES + Jacobi
 20 p2_nonlinear_nx128   p2, kappa = 1 + e*e, 128^2, CG
             (15-20: the JAX package's L2 at rtol 1e-4)
 3d kernels_advect   the four thermal kernels' advection (ADVECT) cases
             against their plain versions at phases 3 and 3c's shapes,
             f64 and f32 (the same bounds): "state" and "full", steady
             and at DIRK-2,2 stage-1 alphas with m = 1, the velocity (2,
             1[, 0.5]) scalar and the rotating field per qp; CUDA-event
             medians of 20 (plain: its one check call)
 21 cdr_gold_nx40   the reference's cdr/2D_manufactured (v = (2, 1),
             reaction 0.5 c^2), direct: L2(c) = 0.00101714 (rtol 2e-5)
 22-29 CDR_DECKS   cdr 512^2 (v = (2, 1), reaction 0), its nonlinear
             twin (reaction 0.5 c^2), the rotating-field DIRK-2,2 deck
             (density 2, 8 steps to t = 0.4), thermal 'include advection'
             512^2, cdr hex 40^3 and nonlinear 40^3, cdr p2 128^2 and
             nonlinear 128^2; GMRES + Jacobi, TOL 1e-10, the JAX
             package's L2 at rtol 1e-4 (tools/jax_references.py)
 3e kernels_ns_elem   ns_elem_full (the B1 Navier-Stokes kernel) against
             its plain version on the channel: hex 64^3 and 31x23x15 on
             [0,5]x[0,1]x[0,1], p2 512x128 and 250x61 on [0,5]x[0,1],
             f64 and f32 (the same bounds), residual and rows each, the
             three cases of phase 3b; CUDA-event medians of 20 (plain:
             its one call)
 30-33 NS_ELEM_DECKS   the channel on hex p1 (uz = 0 on the walls too)
             and on p2 quads (quadrature 4): ns3d_channel_direct_nx20
             (20x4x4, PSPG, steady, direct, TOL 1e-8, rtol 1e-4),
             ns3d_startup_dirk22_nx64 (64x16x16, 75,140 DOFs, the start-up
             of phase 13, rtol 1e-6), p2ns_channel_direct_nx64 (64x16,
             12,771 DOFs, rtol 1e-4), p2ns_startup_dirk22_nx128 (128x32,
             50,115 DOFs, rtol 1e-6): the JAX package's L2 of every
             variable (tools/jax_references.py)
 3f kernels_set   set_node_full (the module-set kernel, one source
             generated per deck) against its plain version at 1024x256
             and 1000x243, f64 and f32 (the same bounds), residual and
             rows each: NS + thermal PSPG steady; NS + thermal advected
             by (ux, uy), PSPG+SUPG at DIRK-2,2 stage-1 alphas with
             seeded u_dot; NS + cdr (velocity (ux, uy), source ux 1 + 0.1
             c^2) at that stage; thermal + cdr with kappa = 1 + e*c; cdr
             with the velocity (c, 1); CUDA-event medians of 20 (plain:
             its one check call)
 34 boussinesq_gold_nx8_beta1, _beta0   the JAX package's Boussinesq deck
             (tests/test_flow.py:63-98), direct: max |ux| equals JAX's to
             rtol 1e-8 at beta = 1 and is below 1e-3 of it at beta = 0
 35-37 SET_DECKS   boussinesq_cavity_startup_nx128 (the differentially
             heated cavity from rest, Ra = 1e3, Pr = 0.71, DIRK-2,2, 2
             steps of 0.01 (cut from 4), GMRES + Jacobi: L2 of ux, uy and
             e),
             ns_cdr_startup_nx256 (the channel start-up with cdr
             advected by (ux, uy) and source ux 1 + 0.1 c^2: ux, uy, pr,
             c) and ns_channel_visc_nonlinear_direct_nx128 (viscosity 1 +
             0.1 ux^2, direct): the JAX package's L2 at rtol 1e-6 (NS +
             cdr: 1e-4, the agreement its capped GMRES solves leave in
             L2(pr))
 3g kernels_set_elem   set_elem_full (the element-tile module-set
             kernel, one source generated per deck) against its plain
             version at hex 64^3 and 31x23x15, p2 512x128 and 250x61, f64
             and f32 (the same bounds), residual rows and Jacobian rows
             each: NS + thermal PSPG steady (hex, nd 40), NS + cdr
             PSPG+SUPG at DIRK-2,2 stage-1 alphas (hex, 40), NS + thermal
             advected PSPG+SUPG at that stage (p2, 36), NS with viscosity
             1 + 0.1 ux^2 (hex, 32), thermal + cdr with kappa = 1 + e*c
             (p2, 18), cdr with the velocity (c, 1, 0.5) (hex, 8);
             CUDA-event medians of 20 (plain: its one check call)
 38-43 SET_ELEM_DECKS   ns3d_cdr_startup_dirk22_nx64 (the hex start-up
             of deck 31 with cdr in the set, 93,925 DOFs),
             ns3d_thermal_channel_direct_nx20 and
             p2ns_thermal_channel_direct_nx64 (mixed convection: NS +
             thermal advected by the flow, e = 1 bottom / 0 top, direct),
             ns3d_channel_visc_nonlinear_direct_nx20 (viscosity 1 + 0.1
             ux^2), thermal_cdr_p2_nx128 (kappa = 1 + e*c, 132,098 DOFs)
             and cdr_hex_state_velocity_nx48 (velocity (c, 1, 0.5)): the
             JAX package's L2 of every variable at rtol 1e-6

The reference L2 values are the JAX package's, computed in f64 on the
CPU, or the reference's golds. Each deck runs one assembly before its
solve timer (reported as warmup_s). Kernel launch counts are reset just
before each deck's Problem.run() and read just after it, before the
assembly timing; so are the calls of the assembler's fused provider. A
fused deck must launch its kernel exactly once per fused res_and_jac
call (each Newton iteration and each stage's converged check), plus,
for the state kernel in a transient deck, twice per stage (the coord
part on the beta_u and beta_t grids), and the other kernels never: phases
4, 5, 7 and 8 run thermal_node_state, 6 and 9 thermal_node_full, 11-13
ns_node_full (once per fused res_and_jac call, no thermal kernel), 14,
15, 17 and 19 thermal_elem_state, 16, 18 and 20 thermal_elem_full,
each of 21-29 the kernel its CDR_DECKS entry names, 30-33
ns_elem_full (once per fused res_and_jac call, no other kernel; the
2D p1 NS decks 11-13 never launch it), 34-37 set_node_full and 38-43
set_elem_full (once per fused res_and_jac call, no other kernel). The
`kernels` line
reports the sums over the decks, each kernel's error, times and bound
(bytes or operations, whichever is larger; see `bound`) at its quoted
case, for the four thermal kernels the same of their advection case
with the launches of decks 21-29 ("advect"), and for set_elem_full each
phase 3g case ("cases", f64 at the divisible shape).
Any failure raises; the last line of a passing run is {"ok": true,
"device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode


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


def quad_tables(N0, N1, device, dtype, lx=1.0, ly=1.0):
    """Reference-quad tables of a uniform N0 x N1 grid on the box [0, lx]
    x [0, ly], and the quadrature-point offsets inside an element."""
    import numpy as np
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    disc = Discretization(box_mesh("quad", nx=1, ny=1, xmax=lx / N0,
                                   ymax=ly / N1), [("e", "HGRAD", 1)], 2)
    key = ("HGRAD", 1)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], device, dtype)
    return tab, np.asarray(disc.ip[0])


# DIRK-2,2 stage 1 at dt = 0.05: alpha_u = A11/b1, alpha_t = 1/(dt b1)
DIRK22_STAGE1 = (0.5, 40.0)


def qp_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded random node grids u, beta_u, beta_t, and per-qp (E, Q)
    tensors: kappa = 1 + 0.5 x y, m = 1 + 0.5 x; for kappa = 1 + e*e
    with source SOURCE_NL the tensors S, a seeded dS/de, K, dK/de at u
    (steady),
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
        # dS/de is 0 for this source; a seeded one checks its column term
        dS = torch.rand(uq.shape, generator=gen, device=device,
                        dtype=dtype) - 0.5
        return [t.reshape(-1, tab.Q).contiguous()
                for t in (S, dS, 1.0 + uq * uq, 2.0 * uq)]
    au, at = DIRK22_STAGE1
    ue = (au * u + bu).contiguous()
    ueq, udq = at_qps(ue), at_qps(at * u + bt)
    return (u, kxy, mx, full_inputs(at_qps(u), -f),
            (ue, full_inputs(ueq, udq - f)))


def cuda_ms(fn, reps=20, warm=True):
    """Median of `reps` CUDA-event timings of fn(), after a warm-up call
    (warm=False: the caller's last call of fn was one)."""
    if warm:
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


def timed(fn):
    """(fn(), its CUDA-event time in ms): one call."""
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


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
            work = (N0, N1, tab.Q, dtype)
            cases = [
                ("thermal_node_state", "kappa=1.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab),
                 thermal_work("state", *work, 1.0, None)),
                ("thermal_node_state", "kappa=1+0.5xy",
                 lambda: fp.thermal_node_state(u, kxy, tab),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab),
                 thermal_work("state", *work, kxy, None)),
                ("thermal_node_state", "dirk22 kappa=1.0 m=2.0",
                 lambda: fp.thermal_node_state(u, 1.0, tab, st2),
                 lambda: fp.thermal_node_state_plain(u, 1.0, tab, st2),
                 thermal_work("state", *work, 1.0, st2)),
                ("thermal_node_state", "dirk22 kappa=1+0.5xy m=1+0.5x",
                 lambda: fp.thermal_node_state(u, kxy, tab, stx),
                 lambda: fp.thermal_node_state_plain(u, kxy, tab, stx),
                 thermal_work("state", *work, kxy, stx)),
                ("thermal_node_full", "kappa=1+e*e",
                 lambda: fp.thermal_node_full(u, S, dS, K, dK, tab),
                 lambda: fp.thermal_node_full_plain(u, S, dS, K, dK, tab),
                 thermal_work("full", *work, None, None, (S, dS, K, dK))),
                ("thermal_node_full", "dirk22 kappa=1+e*e m=1.0",
                 lambda: fp.thermal_node_full(ue, *tr, tab, st1),
                 lambda: fp.thermal_node_full_plain(ue, *tr, tab, st1),
                 thermal_work("full", *work, None, st1, tr)),
            ]
            for name, label, kern, plain, (nbytes, nflops) in cases:
                ref, plain_ms = timed(plain)
                out = kern()
                torch.cuda.synchronize()
                err, scale = max_err(out, ref)
                ok = err <= rtol * scale
                rec = {"phase": "kernels", "kernel": name, "case": label,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": [N0, N1], "max_abs_err": err,
                       "max_abs_plain": scale, "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(kern), "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
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


# ----------------------------------------------------------------------
# Navier-Stokes
# ----------------------------------------------------------------------

# the reference's NS channel (navierstokes/channel, 50x10; bench.py:49-62
# sizes it NY = NX/4): [0,5]x[0,1], Poiseuille flow ux = 0.5 y (1-y)
# driven by source ux = 1
NS_TRUE = {"ux": "0.5*y*(1.0-y)", "uy": "0.0", "pr": "0.0"}
# the JAX package's f64 CPU L2 (ux, pr, uy) of the 128x32 direct deck
NS_DIRECT_128 = (1.88440e-4, 2.86955e-3, 1.22447e-5)
# the start-up deck at n x n/4: (rtol, the JAX package's f64 CPU L2 (ux,
# pr, uy) at t = 0.02 and 0.04). At 128x32 every GMRES solve converges
# (1,500 iterations each); at 256x64 every one stops at its 2,000-iteration
# cap, but each stage's Newton solve still converges in two steps
# (||r||/||r0|| <= 2e-11), so at both sizes the two packages agree to
# rounding. (The 512x128 deck, whose stages 6-8 stall above the tolerance
# in both packages, left the script to make room for the B1
# Navier-Stokes decks: it took 43.7 s of solve; its reference is in
# ROADMAP.md.)
NS_STARTUP = {
    128: (1e-6, {0.02: (0.167438940563, 1.85237941387e-3,
                        2.16197800775e-5),
                 0.04: (0.137443725666, 2.99319670322e-3,
                        2.31845902790e-5)}),
    256: (1e-6, {0.02: (0.16743666533719045, 0.00041739961509650926,
                        4.619296516076629e-06),
                 0.04: (0.13743625171698778, 0.0005461661778793412,
                        4.919212602818986e-06)}),
}
# DIRK-2,2 stage 1 at dt = 0.01: alpha_u = A11/b1, alpha_t = 1/(dt b1)
NS_STAGE1 = (0.5, 200.0)


def ns_deck(nx, ny, solver, supg=False):
    """The NS channel deck with PSPG (and SUPG), at rest initially."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "xmin": 0.0,
                 "xmax": 5.0, "ymin": 0.0, "ymax": 1.0, "NX": nx,
                 "NY": ny},
        "Physics": {"modules": "navier stokes", "usePSPG": True,
                    "useSUPG": supg,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 0.0},
                        "uy": {"bottom": 0.0, "top": 0.0}},
                    "Initial conditions": {"scalar data": True, "ux": 0.0,
                                           "uy": 0.0, "pr": 0.0}},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1},
                           "quadrature": 2},
        "Solver": dict({"solver": "steady-state"}, **solver),
        "Postprocess": {"compute errors": True,
                        "True solutions": dict(NS_TRUE)},
        "Functions": {"source ux": "1.0"},
    }


# the start-up from rest: DIRK-2,2, 4 steps of 0.01, nonlinear TOL 1e-8,
# the default linear solver (GMRES + Jacobi)
NS_STARTUP_SOLVER = {"solver": "transient",
                     "transient Butcher tableau": "DIRK-2,2",
                     "final time": 0.04, "number of steps": 4,
                     "nonlinear TOL": 1e-8}


def ns_startup_deck(nx):
    """The channel started from rest, PSPG+SUPG (NS_STARTUP_SOLVER)."""
    return ns_deck(nx, nx // 4, NS_STARTUP_SOLVER, supg=True)


def ns_elem_deck(mesh, nx, solver, supg=False):
    """The channel deck on hex p1 (nx x nx/4 x nx/4 on [0,5]x[0,1]x[0,1],
    uz = 0 on the no-slip walls too) or on p2 quads (nx x nx/4,
    quadrature 4): the B1 Navier-Stokes decks."""
    cfg = ns_deck(nx, nx // 4, solver, supg)
    phys = cfg["Physics"]
    if mesh == "hex":
        cfg["Mesh"].update({"dimension": 3, "element type": "hex",
                            "zmin": 0.0, "zmax": 1.0, "NZ": nx // 4})
        phys["Dirichlet conditions"]["uz"] = {"bottom": 0.0, "top": 0.0}
        phys["Initial conditions"]["uz"] = 0.0
        cfg["Discretization"]["order"]["uz"] = 1
        cfg["Postprocess"]["True solutions"]["uz"] = "0.0"
    else:
        cfg["Discretization"] = {"order": {"ux": 2, "uy": 2, "pr": 2},
                                 "quadrature": 4}
    return cfg


def ns_elem_startup_deck(mesh, nx):
    """ns_startup_deck's start-up on hex or p2 (ns_elem_deck)."""
    return ns_elem_deck(mesh, nx, NS_STARTUP_SOLVER, supg=True)


NS_DIRECT = {"use direct solver": True, "nonlinear TOL": 1e-8}
# name -> (deck function of nx, nx on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}); tools/jax_references.py runs the
# same deck functions through the JAX package for those references
# (set-up / solve s there: 0.09 / 6.4, 3.2 / 162, 0.5 / 46, 0.8 / 376)
NS_ELEM_DECKS = {
    # 20x5x5 hex, 3,024 DOFs
    "ns3d_channel_direct_nx20": (
        lambda n: ns_elem_deck("hex", n, NS_DIRECT), 20, 1e-4,
        {0.0: {"ux": 0.00793801228220015, "uy": 0.0007936004272299433,
               "uz": 0.0029675811517704924, "pr": 0.042924342437798815}}),
    # 64x16x16 hex, 75,140 DOFs, 16,384 elements
    "ns3d_startup_dirk22_nx64": (
        lambda n: ns_elem_startup_deck("hex", n), 64, 1e-6,
        {0.02: {"ux": 0.16744823526484015, "uy": 8.381002276679228e-05,
                "uz": 4.405179646999185e-05, "pr": 0.0068351997434308535},
         0.04: {"ux": 0.13747407717425109, "uy": 9.245400548791375e-05,
                "uz": 7.421650819321026e-05, "pr": 0.012396608629087216}}),
    # 64x16 p2, 12,771 DOFs
    "p2ns_channel_direct_nx64": (
        lambda n: ns_elem_deck("p2", n, NS_DIRECT), 64, 1e-4,
        {0.0: {"ux": 0.00023598676601114437, "uy": 5.4147272316409495e-05,
               "pr": 0.007146123290226088}}),
    # 128x32 p2, 50,115 DOFs
    "p2ns_startup_dirk22_nx128": (
        lambda n: ns_elem_startup_deck("p2", n), 128, 1e-6,
        {0.02: {"ux": 0.16743590729451366, "uy": 1.9943851165782234e-05,
                "pr": 0.001385678830385292},
         0.04: {"ux": 0.13743376480842512, "uy": 2.150480520381376e-05,
                "pr": 0.0019810571601949407}}),
}


def boussinesq_deck(n, beta=1.0):
    """The JAX package's Boussinesq test (tests/test_flow.py:63-98):
    navier stokes + thermal on n x n p1 quads, PSPG, steady, direct;
    source uy -1 and rho beta (e - T_ambient) source_d in each momentum
    equation, e = 1 on the left and 0 on the right."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "navier stokes,thermal",
                    "usePSPG": True, "beta": beta, "T_ambient": 0.0,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"all boundaries": 0.0},
                        "uy": {"all boundaries": 0.0},
                        "e": {"left": 1.0, "right": 0.0}}},
        "Functions": {"source uy": "-1.0", "source ux": "0.0",
                      "thermal source": "0.0"},
        "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1, "e": 1},
                           "quadrature": 2},
        "Solver": {"solver": "steady-state", "use direct solver": True,
                   "max nonlinear iters": 8, "nonlinear TOL": 1e-10},
        "Postprocess": {"compute errors": False},
    }


# the differentially heated cavity's Rayleigh and Prandtl numbers (de Vahl
# Davis 1983): beta = Ra Pr multiplies the buoyancy of source uy = -1
CAVITY_RA, CAVITY_PR = 1.0e3, 0.71
# the start-up's first 2 of NS_STARTUP_SOLVER's 4 steps, for the script's
# time: Newton runs to its cap in every stage (below)
CAVITY_SOLVER = dict(NS_STARTUP_SOLVER, **{"final time": 0.02,
                                           "number of steps": 2})


def cavity_deck(n):
    """The differentially heated square cavity started from rest: n x n p1
    quads on the unit square, no-slip walls, e = 1 on the left and 0 on
    the right, adiabatic top and bottom; thermal advected by (ux, uy),
    viscosity Pr, thermal diffusion 1; PSPG+SUPG, DIRK-2,2, 2 steps of
    0.01 (CAVITY_SOLVER), the default solver. No true solution: the L2
    lines are the fields' norms."""
    zero = {v: "0.0" for v in ("ux", "uy", "pr", "e")}
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Physics": {"modules": "navier stokes,thermal", "usePSPG": True,
                    "useSUPG": True, "include advection": True,
                    "beta": CAVITY_RA * CAVITY_PR, "T_ambient": 0.0,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"all boundaries": 0.0},
                        "uy": {"all boundaries": 0.0},
                        "e": {"left": 1.0, "right": 0.0}},
                    "Initial conditions": dict(
                        {"scalar data": True},
                        **{v: 0.0 for v in zero})},
        "Functions": {"source uy": "-1.0", "viscosity": str(CAVITY_PR),
                      "thermal diffusion": "1.0", "advection x": "ux",
                      "advection y": "uy"},
        "Discretization": {"order": {v: 1 for v in zero}, "quadrature": 2},
        "Solver": dict(CAVITY_SOLVER),
        "Postprocess": {"compute errors": True, "True solutions": zero},
    }


def add_cdr(cfg):
    """A p1 channel deck with cdr in the set: c = 1 on the left, diffusion
    0.01, advected by the flow (ux, uy[, uz]), reaction 0; NS forced by
    source ux 1 + 0.1 c^2 (the reference's
    Multiphysics/NavierStokes-CDR/Fully-Coupled couplings)."""
    phys = cfg["Physics"]
    phys["modules"] = "navier stokes,cdr"
    phys["Dirichlet conditions"]["c"] = {"left": 1.0}
    phys["Initial conditions"]["c"] = 0.0
    cfg["Discretization"]["order"]["c"] = 1
    cfg["Functions"].update({"source ux": "1.0 + 0.1*c^2",
                             "diffusion": "0.01", "xvel": "ux",
                             "yvel": "uy", "reaction": "0.0"})
    if cfg["Mesh"]["dimension"] == 3:
        cfg["Functions"]["zvel"] = "uz"
    cfg["Postprocess"]["True solutions"]["c"] = "0.0"
    return cfg


def ns_cdr_deck(nx):
    """The channel start-up (ns_startup_deck at nx x nx/4) with cdr in the
    set (add_cdr)."""
    return add_cdr(ns_startup_deck(nx))


def ns_visc_deck(nx):
    """The channel at nx x nx/4, PSPG, steady, direct, with the viscosity
    1 + 0.1 ux^2 (an NS coefficient that reads the state)."""
    cfg = ns_deck(nx, nx // 4, NS_DIRECT)
    cfg["Functions"]["viscosity"] = "1.0 + 0.1*ux*ux"
    return cfg


# the Boussinesq deck's reference: the JAX package's max |ux| at beta = 1
# (f64, CPU; tools/jax_references.py boussinesq_gold_nx8; 8.3e-18 at
# beta = 0)
BOUSSINESQ_MAXU = 0.0037584716736223547
# name -> (deck function of n, n on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}), as NS_ELEM_DECKS; every assembly
# of these decks is one set_node_full launch. The cavity's pressure is
# determined up to a constant (no-slip on every wall), which each
# package's Krylov solves pick: its L2 is no check.
SET_DECKS = {
    # cut from 256^2 (264,196 DOFs): the JAX CPU reference ran over 30
    # minutes there and was stopped; 66,564 DOFs; 2 steps, cut from 4
    # (CAVITY_SOLVER), 265 s of JAX CPU solve (822 s for 4 steps, whose
    # t = 0.02 numbers are these). Its stages do not all converge (at Ra
    # = 1e3, the lowest of the benchmark's range): Newton runs to its cap
    # of 10 with every GMRES solve at its 2,000 cap, in both packages
    # alike; they agree to 9e-10
    "boussinesq_cavity_startup_nx128": (
        cavity_deck, 128, 1e-6,
        {0.01: {"ux": 0.2093494809197624, "uy": 0.3393436708148743,
                "e": 0.2298320688295235},
         0.02: {"ux": 0.4716255450389182, "uy": 0.639036151441178,
                "e": 0.28996953159540934}}),
    # 66,820 DOFs; 316 s of JAX CPU solve. Each stage's Newton solve
    # meets its TOL in two steps, but every GMRES solve stops at its
    # 2,000 cap, and L2(pr), the least determined field, agrees to 6e-5
    # (ux, uy and c to 2e-9): rtol 1e-4
    "ns_cdr_startup_nx256": (
        ns_cdr_deck, 256, 1e-4,
        {0.02: {"ux": 0.16742995154868626, "uy": 4.618762002178137e-06,
                "pr": 0.0007769102912303964, "c": 0.10692664402300237},
         0.04: {"ux": 0.13742098860500176, "uy": 4.950538437048563e-06,
                "pr": 0.0012318709757935503, "c": 0.12248983317628381}}),
    # 12,771 DOFs; 34 s of JAX CPU solve
    "ns_channel_visc_nonlinear_direct_nx128": (
        ns_visc_deck, 128, 1e-6,
        {0.0: {"ux": 0.00025861804009831747, "uy": 1.2241599309508333e-05,
               "pr": 0.0028695719608056725}}),
}


def thermal_cdr_deck(n, mesh="p1"):
    """thermal + cdr on n x n p1 (or p2, quadrature 4) quads, steady:
    kappa = 1 + e c (the set's density reads both variables), cdr
    advected by (2, 1)."""
    cfg = deck(n, kappa="1.0 + e*c", solver={"nonlinear TOL": 1e-10})
    cfg["Physics"]["modules"] = "thermal,cdr"
    cfg["Physics"]["Dirichlet conditions"]["c"] = {"all boundaries": 0.0}
    cfg["Discretization"]["order"]["c"] = 1
    if mesh == "p2":
        cfg["Discretization"] = {"order": {"e": 2, "c": 2}, "quadrature": 4}
    cfg["Functions"].update({"source": CDR_SOURCE, "xvel": "2.0",
                             "yvel": "1.0", "reaction": "0.0"})
    cfg["Postprocess"]["True solutions"]["c"] = S_TRUE
    return cfg


def cdr_state_velocity_deck(n):
    """cdr on n x n p1 quads, steady, with the velocity (c, 1): a
    coefficient that reads the state."""
    return cdr_deck(n, vel=("c", "1.0"))


# phase 3f: name -> (deck function of n, box, stage alphas or None, time
# step); each case's weak form and row classes come from its deck at 4 x
# 4, its element size from the shape
SET_KERNEL_CASES = {
    "ns+thermal pspg steady": (lambda n: boussinesq_deck(n), (1.0, 1.0),
                               None, 1.0),
    "ns+thermal advected pspg+supg dirk22 stage 1": (
        cavity_deck, (1.0, 1.0), NS_STAGE1, 0.01),
    "ns+cdr velocity (ux, uy), source 1 + 0.1 c^2, dirk22 stage 1": (
        ns_cdr_deck, (5.0, 1.0), NS_STAGE1, 0.01),
    "thermal+cdr kappa = 1 + e*c steady": (thermal_cdr_deck, (1.0, 1.0),
                                           None, 1.0),
    "cdr velocity (c, 1) steady": (cdr_state_velocity_deck, (1.0, 1.0),
                                   None, 1.0),
}
SET_SHAPES = ((1024, 256), (1000, 243))


def set_case(name, h):
    """(SetForm at element size h, SetScalars, jac_idx, Stage or None) of
    a phase 3f case, from its deck at 4 x 4 on the CPU."""
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    build, _box, alphas, dt = SET_KERNEL_CASES[name]
    fused = Problem(build(4), device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    f = fused.form
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient)
    sc = SetScalars(0.0125, dt, ())
    au, at = alphas or (1.0, 0.0)
    jac_idx = fused._classify(sc, au, at, alphas is None)[0]
    return form, sc, jac_idx, None if alphas is None else Stage(au, at,
                                                                None)


def set_inputs(nv, dims, lat, device, dtype, gen, stage):
    """Seeded u_eval (and, at a stage, u_dot) grids of nv variables on an
    element grid of `dims` read through lattice `lat`."""
    shape = (nv,) + tuple(lat.stride * n + 1 for n in dims)
    ue = torch.rand(shape, generator=gen, device=device, dtype=dtype) - 0.5
    if stage is None:
        return ue.contiguous(), None
    ud = torch.rand(shape, generator=gen, device=device, dtype=dtype) - 0.5
    return ue.contiguous(), (200.0 * ud).contiguous()


def phase_set_kernels(device, shapes=SET_SHAPES):
    """set_node_full (each case's generated kernel) against its plain
    version (residual and rows each within rtol of its max |plain|),
    with CUDA-event medians of 20 (kernel), the plain version's one check
    call and the bound of each case."""
    import math
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import QUAD_P1
    summary = None
    for name, (_build, box, _alphas, _dt) in SET_KERNEL_CASES.items():
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for i, (N0, N1) in enumerate(shapes):
                gen = torch.Generator(device=device).manual_seed(4321)
                tab, ip0 = quad_tables(N0, N1, device, dtype, *box)
                form, sc, jac_idx, stage = set_case(
                    name, math.sqrt(sum(tab.wts)))
                geo = ((0.0, 0.0), (box[0] / N0, box[1] / N1), ip0)
                ue, ud = set_inputs(len(form.variables), (N0, N1),
                                    QUAD_P1, device, dtype, gen, stage)
                args = (form, ue, ud, sc, tab, geo, jac_idx, stage)
                ref, plain_ms = timed(lambda: fs.set_node_full_plain(*args))
                out = fs.set_node_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc_ for e, sc_ in errs)
                nbytes, nflops = set_work(N0, N1, dtype, *args)
                rec = {"phase": "kernels_set", "kernel": "set_node_full",
                       "case": name, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": [N0, N1],
                       "variables": list(form.variables),
                       "jac_rows": len(jac_idx), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fs.set_node_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"set_node_full {name} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and i == 0 and summary is None:
                    summary = rec
    return summary


def ns_rows(pspg, supg, transient, visc_varies, mesh="p1"):
    """The provider's row classification (jac_idx) of a channel call with
    these switches on p1 quads, hex or p2 quads, from a small deck's
    probe on the CPU."""
    from mrhyde_tpu_torch.ops.fused_ns import NSForm
    from mrhyde_tpu_torch.problem import Problem
    solver = {"solver": "transient"} if transient else {}
    cfg = ns_deck(4, 1, solver, supg) if mesh == "p1" \
        else ns_elem_deck(mesh, 4, solver, supg)
    cfg["Physics"]["usePSPG"] = pspg
    if visc_varies:
        cfg["Functions"]["viscosity"] = "0.1 + 0.01*x"
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    coeffs = (1.0, torch.zeros((1, 1)) if visc_varies else 1.0, 1.0) \
        + (0.0,) * (fused.dim - 1)
    form = NSForm(pspg, supg, 1.0, 0.01 if transient else 1.0, transient)
    au, at = NS_STAGE1 if transient else (1.0, 0.0)
    return fused._classify(coeffs, form, au, at, not transient)[0]


def ns_inputs(N0, N1, tab, q_off, device, dtype, gen):
    """Seeded u_eval and u_dot grids (3, N0+1, N1+1) of the channel, and
    the viscosity 0.1 + 0.01 x at the quadrature points, (E, Q)."""
    ue, ud = ((torch.rand((3, N0 + 1, N1 + 1), generator=gen, device=device,
                          dtype=dtype) - 0.5) for _ in range(2))
    ii = torch.arange(N0, device=device, dtype=dtype)[:, None, None]
    qx = torch.as_tensor(q_off[:, 0], device=device, dtype=dtype)
    x = (ii * (5.0 / N0) + qx).expand(N0, N1, tab.Q)
    visc = (0.1 + 0.01 * x).reshape(-1, tab.Q).contiguous()
    return ue.contiguous(), (200.0 * ud).contiguous(), visc


NS_SHAPES = ((1024, 256), (1000, 243))


def phase_ns_kernels(device):
    """ns_node_full against its plain version (residual and rows each
    within rtol of its max |plain|), with CUDA-event medians of 20
    (kernel), the plain version's one check call and the bound of each
    case."""
    import math
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    rows = {"steady": ns_rows(True, False, False, False),
            "steady_x": ns_rows(True, False, False, True),
            "stage": ns_rows(True, True, True, False)}
    summary = None
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for N0, N1 in NS_SHAPES:
            gen = torch.Generator(device=device).manual_seed(4321)
            tab, ip0 = quad_tables(N0, N1, device, dtype, 5.0, 1.0)
            h = math.sqrt(sum(tab.wts))
            ue, ud, visc = ns_inputs(N0, N1, tab, ip0, device, dtype, gen)
            steady = fn.NSForm(True, False, h, 1.0, False)
            stage = fn.NSForm(True, True, h, 0.01, True)
            st1 = Stage(*NS_STAGE1, None)
            cases = [
                ("pspg steady nu=1.0", (ue, None, (1.0, 1.0, 1.0, 0.0), tab,
                                        steady, rows["steady"])),
                ("pspg steady nu=0.1+0.01x",
                 (ue, None, (1.0, visc, 1.0, 0.0), tab, steady,
                  rows["steady_x"])),
                ("pspg+supg dirk22 stage 1",
                 (ue, ud, (1.0, 1.0, 1.0, 0.0), tab, stage, rows["stage"],
                  st1)),
            ]
            for label, args in cases:
                ref, plain_ms = timed(lambda: fn.ns_node_full_plain(*args))
                out = fn.ns_node_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc for e, sc in errs)
                nbytes, nflops = ns_work(N0, N1, tab.Q, dtype, args)
                rec = {"phase": "kernels", "kernel": "ns_node_full",
                       "case": label, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": [N0, N1],
                       "jac_rows": len(args[5]), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok, "ms": cuda_ms(lambda: fn.ns_node_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"ns_node_full {label} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and (N0, N1) == NS_SHAPES[0] \
                        and label == "pspg+supg dirk22 stage 1":
                    summary = rec
    return summary


# ----------------------------------------------------------------------
# 3D hex (p1) and 2D p2 quads: the element kernels (B1)
# ----------------------------------------------------------------------

# the reference's thermal/3D_verification: u = S3 on the unit cube
S3_TRUE = "sin(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"
SOURCE3 = f"12*(pi*pi)*{S3_TRUE}"
GRAD3_SQ = ("(cos(2*pi*x)*sin(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z))^2"
            "+(sin(2*pi*x)*sin(2*pi*y)*cos(2*pi*z))^2")
# -div((1 + u^2) grad u) for u = S3
SOURCE3_NL = (f"12*(pi*pi)*{S3_TRUE}*(1+({S3_TRUE})^2) - 8*(pi*pi)*"
              f"{S3_TRUE}*({GRAD3_SQ})")
SOURCE3_T = f"(12*(pi*pi)*sin(2*pi*t)+2*pi*cos(2*pi*t))*{S3_TRUE}"
# u_t - div((1 + u^2) grad u) for u = T S3, substituted as text
SOURCE3_T_NL = (
    "2*pi*cos(2*pi*t)*S + 12*(pi*pi)*T*S*(1+(T*S)^2) - 8*(pi*pi)*T*T*T*S*"
    "(G)").replace("G", GRAD3_SQ).replace("S", S3_TRUE).replace("T", T_TIME)
# the JAX package's f64 CPU L2 of the B1 decks (ROADMAP's reference
# tables): hex at 40^3 (68,921 DOFs; tools/jax_references.py, set-up /
# solve s on the CPU: 7 / 7, 6 / 21, 6 / 16, 8 / 56, 6 / 14, 7 / 21); p2
# at 256^2 and 128^2 (their error falls 8.0x per halving of h from 64^2,
# so it is no solver noise)
HEX_L2_40 = {"default": 0.0007270667974098038,
             "nonlinear": 0.0007272032496075229,
             "dirk22": 0.00021572480501614192,
             "bdf2_nonlinear": 0.0009381955542444629,
             "cdr": 0.0007230061638483525,
             "cdr_nonlinear": 0.0007230781769732502}
P2_DEFAULT_L2 = 5.029830565509573e-08
P2_NL_L2 = 4.023729085365165e-07
BDF2_SOLVER = {"transient Butcher tableau": "BWE", "transient BDF order": 2,
               "transient startup Butcher tableau": "BWE",
               "transient startup BDF order": 1,
               "transient startup steps": 1, "final time": 0.2,
               "number of steps": 4, "nonlinear TOL": 1e-10,
               "Belos solver": "CG"}


def hex_deck(n, kappa="1.0", source=SOURCE3, solver=None):
    """thermal/3D_verification on an n^3 hex mesh (Dirichlet 0)."""
    cfg = deck(n, kappa, source, solver)
    cfg["Mesh"].update({"dimension": 3, "element type": "hex", "NZ": n})
    cfg["Postprocess"]["True solutions"] = {"e": S3_TRUE}
    return cfg


def hex_transient_deck(n, solver, kappa="1.0", source=SOURCE3_T):
    """The 3D analogue of the 2D transient deck: IC 0, u = T S3."""
    cfg = hex_deck(n, kappa, source, dict({"solver": "transient"}, **solver))
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"e": f"{T_TIME}*{S3_TRUE}"}
    return cfg


def p2_deck(n, kappa="1.0", source=SOURCE, solver=None):
    """The 2D deck with p2 variables, quadrature 4."""
    cfg = deck(n, kappa, source, solver)
    cfg["Discretization"] = {"order": {"e": 2}, "quadrature": 4}
    return cfg


# ----------------------------------------------------------------------
# convection-diffusion-reaction (cdr) and thermal with advection: the
# scalar advection-diffusion-reaction weak form on B2 (2D p1) and B1 (hex,
# p2), u = S (steady) or T S (transient), Dirichlet 0
# ----------------------------------------------------------------------

SX = "2*pi*cos(2*pi*x)*sin(2*pi*y)"
SY = "2*pi*sin(2*pi*x)*cos(2*pi*y)"
S3X = "2*pi*cos(2*pi*x)*sin(2*pi*y)*sin(2*pi*z)"
S3Y = "2*pi*sin(2*pi*x)*cos(2*pi*y)*sin(2*pi*z)"
S3Z = "2*pi*sin(2*pi*x)*sin(2*pi*y)*cos(2*pi*z)"
# -div grad S + (2, 1) . grad S, and 0.5 S^2 for the reaction 0.5*c*c
CDR_SOURCE = f"8*(pi*pi)*{S_TRUE} + 2.0*{SX} + 1.0*{SY}"
CDR_SOURCE_NL = f"{CDR_SOURCE} + 0.5*{S_TRUE}*{S_TRUE}"
CDR3_SOURCE = (f"12*(pi*pi)*{S3_TRUE} + 2.0*{S3X} + 1.0*{S3Y} "
               f"+ 0.5*{S3Z}")
CDR3_SOURCE_NL = f"{CDR3_SOURCE} + 0.5*{S3_TRUE}*{S3_TRUE}"
# the rotating field about the square's centre, and c_t + b . grad c -
# 0.5 div grad c for c = T S (density 2: kappa = D / (rho cp) = 0.5)
ROT_V = ("-4.0*(y-0.5)", "4.0*(x-0.5)")
CDR_ROT_SOURCE = (f"2*pi*cos(2*pi*t)*{S_TRUE} + {T_TIME}*(4*(pi*pi)*"
                  f"{S_TRUE} + ({ROT_V[0]})*{SX} + ({ROT_V[1]})*{SY})")


def cdr_gold_deck():
    """The reference's cdr/2D_manufactured (tests/test_cdr_burgers.py:
    14-32): 40^2, v = (2, 1), reaction 0.5 c^2, direct."""
    return {
        "Mesh": {"dimension": 2, "shape": "quad", "NX": 40, "NY": 40},
        "Functions": {
            "source": "(8*(pi*pi)+0.5*sin(2*pi*x)*sin(2*pi*y))"
                      "*sin(2*pi*x)*sin(2*pi*y)"
                      " + 2.0*2*pi*cos(2*pi*x)*sin(2*pi*y)"
                      " + 1.0*2*pi*sin(2*pi*x)*cos(2*pi*y)",
            "xvel": "2.0", "yvel": "1.0",
            "reaction": "0.5*c*c", "SUPG tau": "0.0",
        },
        "Physics": {"modules": "cdr",
                    "Dirichlet conditions": {"c": {"all boundaries": "0.0"}},
                    "Initial conditions": {"c": "0.0"}},
        "Discretization": {"order": {"c": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "nonlinear TOL": 1e-7,
                   "max nonlinear iters": 4},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": S_TRUE}},
    }


def cdr_deck(n, source=CDR_SOURCE, reaction="0.0", vel=("2.0", "1.0"),
             mesh="p1", solver=None):
    """A steady cdr deck: n^2 p1 quads, n^3 hex (three velocity
    components) or n^2 p2 quads (quadrature 4); nonlinear TOL 1e-10."""
    dim = 3 if mesh == "hex" else 2
    fs = {"source": source, "reaction": reaction}
    fs.update(zip(("xvel", "yvel", "zvel"), vel))
    cfg = {
        "Mesh": {"dimension": dim, "element type": "hex" if dim == 3
                 else "quad", "NX": n, "NY": n},
        "Functions": fs,
        "Physics": {"modules": "cdr",
                    "Dirichlet conditions": {"c": {"all boundaries": 0.0}}},
        "Discretization": {"order": {"c": 2 if mesh == "p2" else 1},
                           "quadrature": 4 if mesh == "p2" else 2},
        "Solver": dict({"solver": "steady-state", "nonlinear TOL": 1e-10},
                       **(solver or {})),
        "Postprocess": {"compute errors": True,
                        "True solutions": {"c": S3_TRUE if dim == 3
                                           else S_TRUE}},
    }
    if dim == 3:
        cfg["Mesh"]["NZ"] = n
    return cfg


def cdr_rotating_deck(n):
    """c = T S in the rotating field, density 2, IC 0, DIRK-2,2, 8 steps
    of 0.05 to t = 0.4."""
    cfg = cdr_deck(n, CDR_ROT_SOURCE, vel=ROT_V, solver={
        "solver": "transient", "transient Butcher tableau": "DIRK-2,2",
        "final time": 0.4, "number of steps": 8})
    cfg["Functions"]["density"] = "2.0"
    cfg["Physics"]["Initial conditions"] = {"c": "0.0"}
    cfg["Postprocess"]["True solutions"] = {"c": f"{T_TIME}*{S_TRUE}"}
    return cfg


def thermal_advection_deck(n):
    """Thermal with 'include advection', b = (2, 1), kappa = 1."""
    cfg = deck(n, source=CDR_SOURCE, solver={"nonlinear TOL": 1e-10})
    cfg["Physics"]["include advection"] = True
    cfg["Functions"].update({"advection x": "2.0", "advection y": "1.0"})
    return cfg


# name -> (deck builder of the mesh size, size on the card, time of the
# held L2, variable, kernel mode, the JAX package's f64 CPU L2 there).
# tools/jax_references.py runs the same builders through the JAX package
# for those references.
CDR_DECKS = {
    # cut from 1024^2: the JAX CPU reference ran over 20 minutes there
    "cdr_nx512": (cdr_deck, 512, 0.0, "c", "state",
                  6.2108675920617964e-06),
    "cdr_nonlinear_nx512": (
        lambda n: cdr_deck(n, CDR_SOURCE_NL, "0.5*c*c"), 512, 0.0, "c",
        "full", 6.209504430940904e-06),
    "cdr_transient_rotating_nx512": (cdr_rotating_deck, 512, 0.4, "c",
                                     "state", 0.0010168969905621037),
    "thermal_advection_nx512": (thermal_advection_deck, 512, 0.0, "e",
                                "state", 6.21086759188614e-06),
    # cut from 64^3, then 48^3, for the script's time (HEX_L2_40)
    "cdr_hex_nx40": (
        lambda n: cdr_deck(n, CDR3_SOURCE, vel=("2.0", "1.0", "0.5"),
                           mesh="hex"), 40, 0.0, "c", "elem_state",
        HEX_L2_40["cdr"]),
    "cdr_hex_nonlinear_nx40": (
        lambda n: cdr_deck(n, CDR3_SOURCE_NL, "0.5*c*c",
                           ("2.0", "1.0", "0.5"), "hex"), 40, 0.0, "c",
        "elem_full", HEX_L2_40["cdr_nonlinear"]),
    # cut from 256^2 for the script's time (66,049 DOFs; its JAX CPU
    # set-up / solve: 1.3 / 21 s)
    "cdr_p2_nx128": (lambda n: cdr_deck(n, mesh="p2"), 128, 0.0, "c",
                     "elem_state", 4.023602960516559e-07),
    "cdr_p2_nonlinear_nx128": (
        lambda n: cdr_deck(n, CDR_SOURCE_NL, "0.5*c*c", mesh="p2"), 128,
        0.0, "c", "elem_full", 4.023603034380792e-07),
}


# the hex decks of kappa = 1, kappa = 1 + e*e, DIRK-2,2 and the nonlinear
# BDF2 as CDR_DECKS holds its decks, at 40^3: cut for the script's time
# (96^3, 80^3, 64^3 and 48^3 before; 7-11 s of host set-up each at 48^3),
# with their JAX references at 40^3 (HEX_L2_40)
HEX_DECKS = {
    "hex_default_nx40": (
        lambda n: hex_deck(n, solver={"nonlinear TOL": 1e-10}), 40, 0.0,
        "e", "elem_state", HEX_L2_40["default"]),
    "hex_nonlinear_nx40": (
        lambda n: hex_deck(n, "1.0 + e*e", SOURCE3_NL,
                           {"nonlinear TOL": 1e-10, "Belos solver": "CG"}),
        40, 0.0, "e", "elem_full", HEX_L2_40["nonlinear"]),
    "hex_transient_dirk22_nx40": (
        lambda n: hex_transient_deck(n, {
            "transient Butcher tableau": "DIRK-2,2", "final time": 0.4,
            "number of steps": 8, "nonlinear TOL": 1e-10}),
        40, 0.4, "e", "elem_state", HEX_L2_40["dirk22"]),
    "hex_transient_nonlinear_bdf2_nx40": (
        lambda n: hex_transient_deck(n, BDF2_SOLVER, "1.0 + e*e",
                                     SOURCE3_T_NL),
        40, 0.2, "e", "elem_full", HEX_L2_40["bdf2_nonlinear"]),
}


ELEM_SHAPES = (("hex", (128, 128, 128)), ("hex", (127, 100, 77)),
               ("p2", (1024, 1024)), ("p2", (1000, 777)))


def elem_tables(mesh, dims, device, dtype, lengths=(1.0, 1.0, 1.0)):
    """(QuadTables, Lattice, qp offsets) of a uniform hex (p1, quadrature
    2) or quad (p2, quadrature 4) grid of `dims` elements on the box
    [0, lengths]."""
    import numpy as np
    from mrhyde_tpu_torch.assembly.discretization import Discretization
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.ops.fused_elem import basis_lattice
    from mrhyde_tpu_torch.ops.fused_p1 import QuadTables
    cell, order, quad = ("hex", 1, 2) if mesh == "hex" else ("quad", 2, 4)
    size = dict(zip(("xmax", "ymax", "zmax"),
                    (a / n for a, n in zip(lengths, dims))))
    disc = Discretization(box_mesh(cell, **size), [("e", "HGRAD", order)],
                          quad)
    key = ("HGRAD", order)
    tab = QuadTables(disc.basis_vals[key], disc.basis_grads[key][0],
                     disc.wts[0], device, dtype)
    return tab, basis_lattice(cell, order), np.asarray(disc.ip[0])


def qp_xyz(dims, q_off, Q, device, dtype, lengths=(1.0, 1.0, 1.0)):
    """x, y[, z] at the quadrature points of a uniform grid of `dims`
    elements on the box [0, lengths], each (E, Q)."""
    import math
    dim, E = len(dims), math.prod(dims)
    xs = []
    for a in range(dim):
        view = [1] * dim + [Q]
        view[a] = dims[a]
        idx = torch.arange(dims[a], device=device, dtype=dtype)
        off = torch.as_tensor(q_off[:, a], device=device, dtype=dtype)
        xs.append((idx.reshape(view[:dim] + [1]) * lengths[a] / dims[a]
                   + off.reshape([1] * dim + [Q]))
                  .expand(*dims, Q).reshape(E, Q))
    return xs


def elem_inputs(dims, tab, lat, q_off, device, dtype, gen):
    """Seeded random grids u, beta_u, beta_t; per-qp (E, Q) kappa = 1 +
    0.5 x y (z) and m = 1 + 0.5 x; for kappa = 1 + e*e with its
    manufactured source f the tensors S, a seeded dS/de, K, dK/de at u
    (steady)
    and at u_eval = alpha_u u + beta_u, u_dot = alpha_t u + beta_t with m
    (S = m u_dot - f; DIRK-2,2 stage-1 alphas). Returns (u, kxy, m,
    steady full inputs, (u_eval, transient full inputs))."""
    import math
    from mrhyde_tpu_torch.ops.fused_elem import corner_values
    shape = tuple(lat.stride * n + 1 for n in dims)
    u, bu, bt = (torch.rand(shape, generator=gen, device=device,
                            dtype=dtype) - 0.5 for _ in range(3))
    dim = len(dims)
    xs = qp_xyz(dims, q_off, tab.Q, device, dtype)
    kxy = (1.0 + 0.5 * math.prod(xs)).contiguous()
    mx = (1.0 + 0.5 * xs[0]).contiguous()
    sins = [torch.sin(2 * math.pi * x) for x in xs]
    s = math.prod(sins)
    g2 = sum((torch.cos(2 * math.pi * xs[a])
              * math.prod(sins[b] for b in range(dim) if b != a)) ** 2
             for a in range(dim))
    f = 4 * math.pi ** 2 * dim * s * (1 + s * s) - 8 * math.pi ** 2 * s * g2

    def at_qps(g):
        uc = corner_values(g, lat)
        return torch.stack([sum(tab.phi[c][q] * uc[c]
                                for c in range(tab.nc))
                            for q in range(tab.Q)], dim=-1)

    def full_inputs(uq, S):
        # dS/de is 0 for this source; a seeded one checks its column term
        dS = torch.rand(uq.shape, generator=gen, device=device,
                        dtype=dtype) - 0.5
        return [t.contiguous() for t in (S, dS, 1.0 + uq * uq, 2.0 * uq)]
    au, at = DIRK22_STAGE1
    ue = (au * u + bu).contiguous()
    ueq, udq = at_qps(ue), at_qps(at * u + bt)
    return (u, kxy, mx, full_inputs(at_qps(u), -f),
            (ue, full_inputs(ueq, mx * udq - f)))


def phase_elem_kernels(device):
    """thermal_elem_state and thermal_elem_full against their plain
    versions (within rtol of max |plain|, rows and Jacobian rows each),
    hex and p2, f64 and f32, with CUDA-event medians of 20 (plain: its
    one check call) and the bound of each case."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in ELEM_SHAPES:
            gen = torch.Generator(device=device).manual_seed(2468)
            tab, lat, q_off = elem_tables(mesh, dims, device, dtype)
            u, kxy, mx, full, (ue, tr) = elem_inputs(
                dims, tab, lat, q_off, device, dtype, gen)
            stx = Stage(*DIRK22_STAGE1, mx)
            xy = "xyz" if mesh == "hex" else "xy"
            work = (u, dims, tab, dtype)
            cases = [
                ("thermal_elem_state", "kappa=1.0", (u, 1.0, tab, lat),
                 elem_work("state", *work, 1.0, None)),
                ("thermal_elem_state", f"kappa=1+0.5{xy}",
                 (u, kxy, tab, lat), elem_work("state", *work, kxy, None)),
                ("thermal_elem_state", f"dirk22 kappa=1+0.5{xy} m=1+0.5x",
                 (u, kxy, tab, lat, stx), elem_work("state", *work, kxy,
                                                    stx)),
                ("thermal_elem_full", "kappa=1+e*e", (u, *full, tab, lat),
                 elem_work("full", *work, None, None, full)),
                ("thermal_elem_full", "dirk22 kappa=1+e*e m=1+0.5x",
                 (ue, *tr, tab, lat, stx), elem_work("full", *work, None,
                                                     stx, tr)),
            ]
            for name, label, args, (nbytes, nflops) in cases:
                kern = getattr(fe, name)
                plain = getattr(fe, name + "_plain")
                ref, plain_ms = timed(lambda: plain(*args))
                out = kern(*args)
                torch.cuda.synchronize()
                pairs = [max_err(o, r) for o, r in
                         (zip(out, ref) if isinstance(ref, tuple)
                          else [(out, ref)])]
                err = max(e for e, _ in pairs)
                ok = all(e <= rtol * sc for e, sc in pairs)
                rec = {"phase": "kernels", "kernel": name, "case": label,
                       "mesh": mesh, "dtype": str(dtype).replace(
                           "torch.", ""), "shape": list(dims),
                       "max_abs_err": err,
                       "max_abs_plain": max(sc for _, sc in pairs),
                       "rtol": rtol, "ok": ok,
                       "ms": cuda_ms(lambda: kern(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                # the summary line quotes the f64 128^3 hex transient
                # cases
                if dtype == torch.float64 and (mesh, dims) \
                        == ELEM_SHAPES[0] and label.startswith("dirk22"):
                    summary[name] = rec
    return summary


# the B1 Navier-Stokes kernel on the channel [0,5]x[0,1](x[0,1])
# the non-divisible shapes are cut from 61x47x29 and 500x121 (PR 6) for
# the script's time: the plain version takes 0.3-1.0 s a call there
NS_ELEM_SHAPES = (("hex", (64, 64, 64)), ("hex", (31, 23, 15)),
                  ("p2", (512, 128)), ("p2", (250, 61)))
CHANNEL = (5.0, 1.0, 1.0)


def ns_elem_inputs(mesh, dims, device, dtype, gen):
    """(tables, lattice, h, seeded u_eval and u_dot grid stacks (dim + 1,
    *grid), the viscosity 0.1 + 0.01 x at the qps (E, Q)) of a hex or p2
    element grid of the channel."""
    import math
    tab, lat, q_off = elem_tables(mesh, dims, device, dtype, CHANNEL)
    shape = (tab.dim + 1,) + tuple(lat.stride * n + 1 for n in dims)
    ue, ud = ((torch.rand(shape, generator=gen, device=device, dtype=dtype)
               - 0.5) for _ in range(2))
    x = qp_xyz(dims, q_off, tab.Q, device, dtype, CHANNEL)[0]
    visc = (0.1 + 0.01 * x).contiguous()
    h = math.fsum(tab.wts) ** (1.0 / tab.dim)
    return tab, lat, h, ue.contiguous(), (200.0 * ud).contiguous(), visc


def phase_ns_elem_kernels(device, shapes=NS_ELEM_SHAPES):
    """ns_elem_full against its plain version (residual and rows each
    within rtol of its max |plain|) on hex and p2, f64 and f32, with
    CUDA-event medians of 20 (kernel) and the bound of each case: PSPG
    steady with viscosity 1 and 0.1 + 0.01 x, PSPG+SUPG at
    DIRK-2,2 stage-1 alphas (0.5, 200) with seeded u_dot; each record
    gives the share of the bound the kernel reaches. The plain version's
    time is that of its one call, the check's (CUDA events). Returns the
    quoted case: f64, hex 64^3, the stage."""
    from mrhyde_tpu_torch.ops import fused_ns as fn
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    rows = {(mesh, key): ns_rows(True, key == "stage", key == "stage",
                                 key == "steady_x", mesh)
            for mesh in ("hex", "p2")
            for key in ("steady", "steady_x", "stage")}
    summary = None
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in shapes:
            gen = torch.Generator(device=device).manual_seed(8642)
            tab, lat, h, ue, ud, visc = ns_elem_inputs(mesh, dims, device,
                                                       dtype, gen)
            src = (1.0,) + (0.0,) * (tab.dim - 1)
            steady = fn.NSForm(True, False, h, 1.0, False)
            stage = fn.NSForm(True, True, h, 0.01, True)
            st1 = Stage(*NS_STAGE1, None)
            cases = [
                ("pspg steady nu=1.0", (ue, None, (1.0, 1.0, *src), tab,
                                        lat, steady, rows[mesh, "steady"])),
                ("pspg steady nu=0.1+0.01x",
                 (ue, None, (1.0, visc, *src), tab, lat, steady,
                  rows[mesh, "steady_x"])),
                ("pspg+supg dirk22 stage 1",
                 (ue, ud, (1.0, 1.0, *src), tab, lat, stage,
                  rows[mesh, "stage"], st1)),
            ]
            for label, args in cases:
                ref, plain_ms = timed(lambda: fn.ns_elem_full_plain(*args))
                out = fn.ns_elem_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                del out, ref
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc for e, sc in errs)
                nbytes, nflops = ns_elem_work(dims, dtype, args)
                rec = {"phase": "kernels_ns_elem", "kernel": "ns_elem_full",
                       "case": label, "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims), "jac_rows": len(args[6]),
                       "max_abs_err": err, "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fn.ns_elem_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"ns_elem_full {label} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and (mesh, dims) == shapes[0] \
                        and label == "pspg+supg dirk22 stage 1":
                    summary = rec
    return summary


# ----------------------------------------------------------------------
# module sets and state-reading coefficients on 3D hex and 2D p2 quads:
# the element-tile kernel B1 through the generated set_elem_full
# ----------------------------------------------------------------------

def ns_thermal_channel_deck(mesh, nx):
    """Mixed convection in the channel (ns_elem_deck: hex nx x nx/4 x
    nx/4 or p2 nx x nx/4, PSPG, steady, direct): NS + thermal with the
    Boussinesq term (beta 1, T_ambient 0, source uy -1) and the flow's
    source ux 1; thermal advected by (ux, uy[, uz]), e = 1 on the bottom
    and 0 on the top wall (true e = 1 - y)."""
    cfg = ns_elem_deck(mesh, nx, NS_DIRECT)
    phys = cfg["Physics"]
    phys.update({"modules": "navier stokes,thermal", "beta": 1.0,
                 "T_ambient": 0.0, "include advection": True})
    phys["Dirichlet conditions"]["e"] = {"bottom": 1.0, "top": 0.0}
    phys["Initial conditions"]["e"] = 0.0
    cfg["Discretization"]["order"]["e"] = 2 if mesh == "p2" else 1
    cfg["Functions"].update({"source ux": "1.0", "source uy": "-1.0",
                             "advection x": "ux", "advection y": "uy"})
    if mesh == "hex":
        cfg["Functions"]["advection z"] = "uz"
    cfg["Postprocess"]["True solutions"]["e"] = "1.0-y"
    return cfg


def ns_elem_visc_deck(nx):
    """The hex channel (ns_elem_deck, PSPG, steady, direct) with the
    viscosity 1 + 0.1 ux^2."""
    cfg = ns_elem_deck("hex", nx, NS_DIRECT)
    cfg["Functions"]["viscosity"] = "1.0 + 0.1*ux*ux"
    return cfg


# name -> (deck function of n, n on the card, rtol, {held time: the JAX
# package's f64 CPU L2 per variable}), as SET_DECKS; every assembly of
# these decks is one set_elem_full launch. tools/jax_references.py runs
# the same deck functions through the JAX package for those references.
SET_ELEM_DECKS = {
    # the full-width deck: the hex start-up of NS_ELEM_DECKS with cdr in
    # the set, 64x16x16 (93,925 DOFs, 16,384 elements, nd = 40); 165 s of
    # JAX CPU solve
    "ns3d_cdr_startup_dirk22_nx64": (
        lambda n: add_cdr(ns_elem_startup_deck("hex", n)), 64, 1e-6,
        {0.02: {"ux": 0.16742864601145643, "uy": 8.380799346010581e-05,
                "pr": 0.006630702844891716, "uz": 4.2494223866583694e-05,
                "c": 0.1657996392173004},
         0.04: {"ux": 0.13743732259423974, "uy": 9.221388229134829e-05,
                "pr": 0.012040041889444056, "uz": 6.827581594586298e-05,
                "c": 0.1704585143860053}}),
    # mixed convection, 20x5x5 hex (3,780 DOFs, nd = 40); 6.3 s
    "ns3d_thermal_channel_direct_nx20": (
        lambda n: ns_thermal_channel_deck("hex", n), 20, 1e-6,
        {0.0: {"ux": 0.10599156192928649, "uy": 0.015255381043264049,
               "pr": 0.29369837310744434, "uz": 0.012059791939267333,
               "e": 0.0014663276774370387}}),
    # the same on 64x16 p2 quads (17,028 DOFs, nd = 36); 115 s
    "p2ns_thermal_channel_direct_nx64": (
        lambda n: ns_thermal_channel_deck("p2", n), 64, 1e-6,
        {0.0: {"ux": 0.1030206482202709, "uy": 0.006632863120563855,
               "pr": 0.32817749457768447, "e": 0.0005212417638041555}}),
    # viscosity 1 + 0.1 ux^2, 20x5x5 hex (3,024 DOFs, nd = 32); 5.0 s
    "ns3d_channel_visc_nonlinear_direct_nx20": (
        ns_elem_visc_deck, 20, 1e-6,
        {0.0: {"ux": 0.007999975536123395, "uy": 0.000793521893887483,
               "pr": 0.042929445662579405, "uz": 0.00296556133492944}}),
    # thermal + cdr, kappa = 1 + e c, p2 128^2 (132,098 DOFs, nd = 18);
    # 111 s
    "thermal_cdr_p2_nx128": (
        lambda n: thermal_cdr_deck(n, "p2"), 128, 1e-6,
        {0.0: {"e": 0.0683409929255726, "c": 4.023602960223766e-07}}),
    # cdr with the velocity (c, 1, 0.5), hex 48^3 (117,649 DOFs, nd = 8);
    # 29 s
    "cdr_hex_state_velocity_nx48": (
        lambda n: cdr_deck(n, CDR3_SOURCE, vel=("c", "1.0", "0.5"),
                           mesh="hex"), 48, 1e-6,
        {0.0: {"c": 0.029795399604469273}}),
}


def _small(cfg, mesh):
    """The deck on 4x2x2 hex or 4x4 p2 quads: where a phase 3g case takes
    its weak form and row classes from."""
    cfg["Mesh"].update({"NX": 4, "NY": 2, "NZ": 2} if mesh == "hex"
                       else {"NX": 4, "NY": 4})
    return cfg


def ns_thermal_stage_deck(mesh):
    """ns_thermal_channel_deck with SUPG, transient (a DIRK-2,2 stage)."""
    cfg = ns_thermal_channel_deck(mesh, 4)
    cfg["Physics"]["useSUPG"] = True
    cfg["Solver"] = dict(NS_STARTUP_SOLVER)
    return cfg


# phase 3g: name -> (mesh, deck function, box, stage alphas or None, time
# step); each case's weak form and row classes come from its deck at
# 4x2x2 (hex) or 4x4 (p2), its element size from the shape; the six
# generated sources are those of SET_ELEM_DECKS
SET_ELEM_KERNEL_CASES = {
    "ns+thermal pspg steady": (
        "hex", lambda: ns_thermal_channel_deck("hex", 4), CHANNEL, None,
        1.0),
    "ns+cdr pspg+supg dirk22 stage 1": (
        "hex", lambda: add_cdr(ns_elem_startup_deck("hex", 4)), CHANNEL,
        NS_STAGE1, 0.01),
    "ns+thermal advected pspg+supg dirk22 stage 1": (
        "p2", lambda: ns_thermal_stage_deck("p2"), CHANNEL, NS_STAGE1,
        0.01),
    "ns viscosity 1 + 0.1 ux^2 pspg steady": (
        "hex", lambda: ns_elem_visc_deck(4), CHANNEL, None, 1.0),
    "thermal+cdr kappa = 1 + e*c steady": (
        "p2", lambda: thermal_cdr_deck(4, "p2"), (1.0, 1.0), None, 1.0),
    "cdr velocity (c, 1, 0.5) steady": (
        "hex", lambda: cdr_deck(4, CDR3_SOURCE, vel=("c", "1.0", "0.5"),
                                mesh="hex"), (1.0, 1.0, 1.0), None, 1.0),
}
SET_ELEM_SHAPES = {"hex": ((64, 64, 64), (31, 23, 15)),
                   "p2": ((512, 128), (250, 61))}


def set_elem_case(name, h):
    """(SetForm at element size h, SetScalars, jac_idx, Stage or None) of
    a phase 3g case, from its deck at 4x2x2 / 4x4 on the CPU."""
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.ops.fused_set import SetForm, SetScalars
    from mrhyde_tpu_torch.problem import Problem
    mesh, build, _box, alphas, dt = SET_ELEM_KERNEL_CASES[name]
    fused = Problem(_small(build(), mesh), device="cpu",
                    dtype=torch.float64).assembler.fused_provider()
    f = fused.form
    form = SetForm(f.modules, f.fm, f.variables, f.params, h, f.transient,
                   f.dim, f.nc)
    sc = SetScalars(0.0125, dt, ())
    au, at = alphas or (1.0, 0.0)
    jac_idx = fused._classify(sc, au, at, alphas is None)[0]
    return form, sc, jac_idx, None if alphas is None else Stage(au, at,
                                                                None)


def phase_set_elem_kernels(device, shapes=SET_ELEM_SHAPES):
    """set_elem_full (each case's generated kernel) against its plain
    version (residual rows and Jacobian rows each within rtol of its max
    |plain|) on hex and p2, f64 and f32, with CUDA-event medians of 20
    (kernel), the plain version's one check call and the bound of each
    case. Returns {case: its f64 record at the first (divisible) shape}."""
    import math
    from mrhyde_tpu_torch.ops import fused_set as fs
    summary = {}
    for name, (mesh, _build, box, _alphas, _dt) in \
            SET_ELEM_KERNEL_CASES.items():
        for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
            for i, dims in enumerate(shapes[mesh]):
                gen = torch.Generator(device=device).manual_seed(2468)
                tab, lat, q_off = elem_tables(mesh, dims, device, dtype,
                                              box)
                form, sc, jac_idx, stage = set_elem_case(
                    name, math.fsum(tab.wts) ** (1.0 / tab.dim))
                geo = ((0.0,) * tab.dim,
                       tuple(b / n for b, n in zip(box, dims)), q_off)
                ue, ud = set_inputs(len(form.variables), dims, lat, device,
                                    dtype, gen, stage)
                args = (form, ue, ud, sc, tab, lat, geo, jac_idx, stage)
                ref, plain_ms = timed(lambda: fs.set_elem_full_plain(*args))
                out = fs.set_elem_full(*args)
                torch.cuda.synchronize()
                errs = [max_err(o, r) for o, r in zip(out, ref)]
                del out, ref
                err = max(e for e, _ in errs)
                ok = all(e <= rtol * sc_ for e, sc_ in errs)
                nbytes, nflops = set_elem_work(dims, dtype, *args)
                rec = {"phase": "kernels_set_elem",
                       "kernel": "set_elem_full", "case": name,
                       "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims),
                       "variables": list(form.variables),
                       "nd": len(form.variables) * len(lat.offsets),
                       "jac_rows": len(jac_idx), "max_abs_err": err,
                       "max_abs_err_res": errs[0][0],
                       "max_abs_plain_res": errs[0][1],
                       "max_abs_err_jac": errs[1][0],
                       "max_abs_plain_jac": errs[1][1], "rtol": rtol,
                       "ok": ok,
                       "ms": cuda_ms(lambda: fs.set_elem_full(*args)),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                rec["share"] = rec["bound_ms"] / rec["ms"]
                emit(rec)
                if not ok:
                    raise SystemExit(f"set_elem_full {name} disagrees with "
                                     f"its plain version: {rec}")
                if dtype == torch.float64 and i == 0:
                    summary[name] = rec
    return summary


ADVECT_SHAPES = (("p1", KERNEL_SHAPES[0]), ("p1", KERNEL_SHAPES[1]),
                 *ELEM_SHAPES)


def advect_call(mesh, kind, plain, head, tab, lat, stage, vel):
    """One call of the thermal kernel of this mesh (node kernels on p1,
    element kernels on hex and p2) and kind ("state", "full"), or of its
    plain version: head is (grid, kappa) or (grid, S, dS, K, dK)."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    suffix = "_plain" if plain else ""
    if mesh == "p1":
        return getattr(fp, f"thermal_node_{kind}{suffix}")(*head, tab, stage,
                                                           vel)
    return getattr(fe, f"thermal_elem_{kind}{suffix}")(*head, tab, lat,
                                                       stage, vel)


def phase_advect_kernels(device):
    """The four thermal kernels with advection (their ADVECT
    instantiations, which cdr and thermal's 'include advection' run)
    against their plain versions, on phases 3 and 3c's shapes, f64 and
    f32 (the same bounds): "state" with kappa 1 or 0.5 and "full" on the
    kappa = 1 + e*e inputs, each steady and at DIRK-2,2 stage-1 alphas
    with m = 1 (cdr), with the velocity (2, 1[, 0.5]) scalar and the
    rotating field (-4 (y - 0.5), 4 (x - 0.5)[, 0.5 + 0.25 z]) per qp;
    CUDA-event medians of 20 (plain: its one check call). Returns the
    quoted case of each kernel: f64, the steady scalar velocity (the main
    path's case), B2 at 1024^2 and B1 on hex at 128^3."""
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    summary = {}
    for dtype, rtol in ((torch.float64, 1e-12), (torch.float32, 1e-5)):
        for mesh, dims in ADVECT_SHAPES:
            gen = torch.Generator(device=device).manual_seed(1357)
            if mesh == "p1":
                tab, q_off = quad_tables(*dims, device, dtype)
                lat = fp.QUAD_P1
            else:
                tab, lat, q_off = elem_tables(mesh, dims, device, dtype)
            u, _kxy, _mx, full, (ue, tr) = elem_inputs(
                dims, tab, lat, q_off, device, dtype, gen)
            xs = qp_xyz(dims, q_off, tab.Q, device, dtype)
            rot = [(-4.0 * (xs[1] - 0.5)).contiguous(),
                   (4.0 * (xs[0] - 0.5)).contiguous(),
                   (0.5 + 0.25 * xs[-1]).contiguous()][:tab.dim]
            const = [2.0, 1.0, 0.5][:tab.dim]
            st1 = fp.Stage(*DIRK22_STAGE1, 1.0)
            b3 = ",0.5" if tab.dim == 3 else ""
            cases = []
            for vname, vel in ((f"b=(2,1{b3})", const), ("b rotating", rot)):
                cases += [
                    ("state", f"{vname} kappa=1", (u, 1.0), None, vel),
                    ("state", f"dirk22 {vname} kappa=0.5 m=1", (u, 0.5), st1,
                     vel),
                    ("full", f"{vname} kappa=1+e*e", (u, *full), None, vel),
                    ("full", f"dirk22 {vname} kappa=1+e*e m=1", (ue, *tr),
                     st1, vel)]
            for kind, label, head, stage, vel in cases:
                def kern():
                    return advect_call(mesh, kind, False, head, tab, lat,
                                       stage, vel)

                def plain():
                    return advect_call(mesh, kind, True, head, tab, lat,
                                       stage, vel)
                ref, plain_ms = timed(plain)
                out = kern()
                torch.cuda.synchronize()
                pairs = [max_err(o, r) for o, r in
                         (zip(out, ref) if isinstance(ref, tuple)
                          else [(out, ref)])]
                err = max(e for e, _ in pairs)
                ok = all(e <= rtol * sc for e, sc in pairs)
                if mesh == "p1":
                    nbytes, nflops = thermal_work(
                        kind, *dims, tab.Q, dtype, head[1] if kind ==
                        "state" else None, stage, head[1:] if kind == "full"
                        else (), vel)
                else:
                    nbytes, nflops = elem_work(
                        kind, u, dims, tab, dtype, head[1] if kind ==
                        "state" else None, stage, head[1:] if kind == "full"
                        else (), vel)
                name = (f"thermal_node_{kind}" if mesh == "p1"
                        else f"thermal_elem_{kind}")
                rec = {"phase": "kernels_advect", "kernel": name,
                       "case": label, "mesh": mesh,
                       "dtype": str(dtype).replace("torch.", ""),
                       "shape": list(dims), "max_abs_err": err,
                       "max_abs_plain": max(sc for _, sc in pairs),
                       "rtol": rtol, "ok": ok, "ms": cuda_ms(kern),
                       "plain_ms": plain_ms,
                       **bound(nbytes, nflops, dtype)}
                emit(rec)
                if not ok:
                    raise SystemExit(f"{name} {label} disagrees with its "
                                     f"plain version: {rec}")
                if dtype == torch.float64 and stage is None \
                        and vel is const and (mesh, dims) in (
                            ("p1", KERNEL_SHAPES[0]), ELEM_SHAPES[0]):
                    summary[name] = rec
    return summary


# ----------------------------------------------------------------------
# bounds: bytes (each input read once, each output written once) over
# 3.35 TB/s, and the operations the function needs (an FMA is 2, a
# divide or a square root 1; the thermal ones counted by hand from the
# weak form, the Navier-Stokes ones by ns_ops) over the card's peak for
# their type: 34 TFLOP/s in f64 and 67 TFLOP/s in f32 outside the tensor
# cores (NVIDIA's H100 SXM data sheet)
# ----------------------------------------------------------------------

HBM_BPS = 3.35e12
PEAK_FLOPS = {torch.float64: 34e12, torch.float32: 67e12}


def bound(nbytes, nflops, dtype):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nflops / PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": nflops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def _qp_len(v):
    return v.numel() if isinstance(v, torch.Tensor) else 0


# The operations are those the function needs: each element's quadrature
# once. The kernels recompute an element's quadrature in each of its four
# node threads (and ns_node_full its values and primal density in each of
# three column threads); that is their design's cost, not the function's.
# With kappa (and a stage's m) scalar, the state part on a uniform mesh is
# one constant nc x nc element matrix times the element's values: nc^2 FMA
# per element.


def _constant_matrix(kappa, stage, vel):
    return not isinstance(kappa, torch.Tensor) and (
        stage is None or not isinstance(stage.mass, torch.Tensor)) and \
        not any(isinstance(b, torch.Tensor) for b in vel or ())


def _advect_flops(kernel, vel, tr, nc, dim):
    """Operations the velocity adds per element and qp: b . grad u_h (2
    dim), and in "state" a phi_c term in each of the nc rows (2 each; a
    stage has it already), in "full" b . grad phi_c' in each of the nc
    column tangents (2 dim each)."""
    if vel is None:
        return 0
    if kernel == "state":
        return 2 * dim + (0 if tr else 2 * nc)
    return 2 * dim + nc * 2 * dim


def thermal_work(kernel, N0, N1, Q, dtype, kappa, stage, full_inputs=(),
                 vel=None):
    """(bytes, flops) of one thermal_node_state / thermal_node_full call
    (csrc/fused_p1_thermal.cu); vel: None or the velocity's
    components."""
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    tr = stage is not None
    mass = _qp_len(stage.mass) if tr else 0
    velb = sum(_qp_len(b) for b in vel or ())
    adv = _advect_flops(kernel, vel, tr, 4, 2)
    if kernel == "state":
        nbytes = it * (2 * nodes + _qp_len(kappa) + mass + velb)
        if _constant_matrix(kappa, stage, vel):
            return nbytes, E * 2 * 4 * 4
        # per element and qp: grad u_h 16, the flux 2, four rows of 5; a
        # stage adds u_h 8, the alphas and the mass lane 4, and 2 per row
        per_q = 16 + 2 + 4 * 5 + (8 + 4 + 4 * 2 if tr else 0) + adv
        return nbytes, E * Q * per_q
    nbytes = it * (2 * nodes + sum(t.numel() for t in full_inputs) + mass
                   + velb + 16 * E)
    # per element and qp: grad u_h 16, the flux 2, four residual rows of
    # 7, the Jacobian's 16 (c, c') pairs of 16 (20 in a stage)
    return nbytes, E * Q * (16 + 2 + 4 * 7 + 16 * (20 if tr else 16) + adv)


def elem_work(kernel, grid, dims, tab, dtype, kappa, stage,
              full_inputs=(), vel=None):
    """(bytes, flops) of one thermal_elem_state / thermal_elem_full call
    (csrc/fused_elem_thermal.cu) on the element grid `dims`: the grid,
    the coefficient tensors and the rows once; each element's quadrature
    once (not the full kernel's per-column recomputation of grad u_h);
    vel: None or the velocity's components."""
    import math
    E, nc, dim, Q = math.prod(dims), tab.nc, tab.dim, tab.Q
    nodes = grid.numel()
    it = torch.finfo(dtype).bits // 8
    tr = stage is not None
    mass = _qp_len(stage.mass) if tr else 0
    velb = sum(_qp_len(b) for b in vel or ())
    adv = _advect_flops(kernel, vel, tr, nc, dim)
    grad_uh = 2 * nc * dim
    if kernel == "state":
        nbytes = it * (nodes + _qp_len(kappa) + mass + velb + nc * E)
        if _constant_matrix(kappa, stage, vel):
            return nbytes, E * 2 * nc * nc
        # per element and qp: grad u_h, the flux dim, nc rows of 2 dim +
        # 2; a stage adds u_h 2 nc, its alphas dim + 2, and 2 per row
        per_q = (grad_uh + dim + nc * (2 * dim + 2)
                 + (2 * nc + dim + 2 + 2 * nc if tr else 0) + adv)
        return nbytes, E * Q * per_q
    nbytes = it * (nodes + sum(t.numel() for t in full_inputs) + mass
                   + velb + (nc + nc * nc) * E)
    # per element and qp: grad u_h, the flux dim, nc residual rows of 2
    # dim + 3, nc column tangents of 4 dim + 1 (a stage: dim + 3 more),
    # nc * nc Jacobian entries of 2 dim + 3
    per_q = (grad_uh + dim + nc * (2 * dim + 3)
             + nc * (4 * dim + 1 + (dim + 3 if tr else 0))
             + nc * nc * (2 * dim + 3) + adv)
    return nbytes, E * Q * per_q


# The Navier-Stokes kernels' operations are counted, not derived by hand:
# the weak form's accumulation (fused_ns.accumulate, the JAX package's
# trace-time sparse forward AD) runs once on (2,)-shaped stand-ins for
# one element's inputs, with this call's coefficients, switches and
# alphas, under _OpCount. Arithmetic on Python floats (the tables, the
# seeds alpha phi_c', the scalar coefficients) is element-independent and
# free, structural zeros are never formed, the constant Jacobian rows
# come back as floats, and the quadrature weights are folded into the
# tables (weights of 1).

class _OpCount(TorchDispatchMode):
    """Counts the distinct arithmetic operations on tensors run under it,
    one per element of a (2,)-shaped result: a multiply, an add, a
    divide, a square root and an elementary function (sin, exp, max,
    ...) are one each (an FMA two); an operation on
    tensors alone (b * b, sqrt(b)) counts once however often it recurs;
    negating, multiplying or dividing by 1, -1 or 0 and adding 0 are
    free, as are selects and copies."""
    ARITH = {"add", "sub", "rsub", "mul", "div", "reciprocal", "sqrt",
             "rsqrt", "pow", "sin", "cos", "tan", "exp", "log", "sinh",
             "cosh", "tanh", "atan2", "abs", "maximum", "minimum"}

    def __init__(self):
        super().__init__()
        self.ops = 0
        self._floats = 0
        self._num = {}     # id(tensor) -> value number
        self._live = []    # the numbered tensors: no id is reused
        self._seen = {}    # (operation, operands) -> value number

    def _operand(self, a):
        if isinstance(a, float):
            # never shared: equal table entries are coincidences of the
            # element's shape, not structure
            self._floats += 1
            return ("float", self._floats)
        if not isinstance(a, torch.Tensor):
            return ("scalar", repr(a))
        if id(a) not in self._num:
            self._num[id(a)] = ("input", len(self._num))
            self._live.append(a)
        return self._num[id(a)]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        name = func.overloadpacket.__name__
        operands = [self._operand(a) for a in args]
        if name in ("add", "mul"):
            operands.sort(key=repr)
        key = (name, tuple(operands), repr(kwargs))
        if key not in self._seen:
            self._seen[key] = ("op", len(self._seen))
            scalars = [a for a in args if isinstance(a, (int, float))]
            free = (name in ("mul", "div")
                    and any(s in (1, -1, 0) for s in scalars)) or (
                name in ("add", "sub", "rsub") and 0 in scalars)
            if name in self.ARITH and not free:
                if out.numel() != 2:
                    raise ValueError(f"{func} on a {tuple(out.shape)} "
                                     "operand: not an element's stand-in")
                self.ops += 1
        if isinstance(out, torch.Tensor):
            self._num[id(out)] = self._seen[key]
            self._live.append(out)
        return out


_NS_OPS = {}


def ns_ops(tab, nc, coeffs, form, stage):
    """Operations per element of one NS kernel call (all its qps): the
    values and gradients at each qp, the density and its sparse
    derivatives, the residual rows and the column tangents and sums of
    every element-varying Jacobian row, as _OpCount counts them on
    fused_ns.accumulate. Cached per (element, coefficients, switches,
    alphas): the element's size changes no count (the check of h = 1
    aside)."""
    from types import SimpleNamespace
    from mrhyde_tpu_torch.ops import fused_ns as fn
    nv, Q = tab.dim + 1, tab.Q
    key = (tab.dim, Q, nc, form.pspg, form.supg, form.transient,
           form.h == 1.0, None if stage is None
           else (stage.alpha_u, stage.alpha_t),
           tuple(None if isinstance(c, torch.Tensor) else c for c in coeffs))
    if key in _NS_OPS:
        return _NS_OPS[key]
    gen = torch.Generator().manual_seed(97)

    def standin():
        return torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    steady = stage is None
    ue = [[standin() for _ in range(nc)] for _ in range(nv)]
    ud = [[0.0 if steady else standin() for _ in range(nc)]
          for _ in range(nv)]
    # a coefficient that reads x, y or z differs at every qp
    per_q = [[standin() if isinstance(c, torch.Tensor) else c
              for c in coeffs] for _ in range(Q)]

    def coeff_at(q):
        rho, visc, *src = per_q[q]
        return rho, visc, src
    folded = SimpleNamespace(Q=Q, dim=tab.dim, phi=tab.phi, grad=tab.grad,
                             wts=[1.0] * Q)
    with _OpCount() as count:
        fn.accumulate(ue, ud, coeff_at, folded, form,
                      1.0 if steady else stage.alpha_u,
                      0.0 if steady else stage.alpha_t, steady)
    _NS_OPS[key] = count.ops
    return count.ops


def ns_work(N0, N1, Q, dtype, args):
    """(bytes, flops) of one ns_node_full call with these arguments: the
    grids and coefficient tensors read once, the node residual and the
    varying Jacobian rows written once; ns_ops per element, and the adds
    of the residual's scatter to the nodes."""
    ue, ud, coeffs, tab, form, jac_idx = args[:6]
    stage = args[6] if len(args) > 6 else None
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    tr = ud is not None
    nbytes = it * (3 * nodes * (3 if tr else 2)
                   + sum(_qp_len(c) for c in coeffs) + len(jac_idx) * E)
    return nbytes, E * ns_ops(tab, 4, coeffs, form, stage) \
        + 3 * (4 * E - nodes)


def ns_elem_work(dims, dtype, args):
    """(bytes, flops) of one ns_elem_full call with these arguments: the
    grids of all variables (and the u_dot ones) and the coefficient
    tensors read once, the nd residual rows and the varying Jacobian rows
    written once; ns_ops per element. (The kernel re-evaluates the
    density on a dual of one tangent per column; that is its design's
    cost, not the function's.)"""
    import math
    ue, ud, coeffs, tab, lat, form, jac_idx = args[:7]
    stage = args[7] if len(args) > 7 else None
    E, nc = math.prod(dims), len(lat.offsets)
    nd = (tab.dim + 1) * nc
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (ue.numel() * (1 if ud is None else 2)
                   + sum(_qp_len(c) for c in coeffs)
                   + (nd + len(jac_idx)) * E)
    return nbytes, E * ns_ops(tab, nc, coeffs, form, stage)


_SET_OPS = {}


def set_ops(form, tab, sc, stage):
    """Operations per element of one set_node_full or set_elem_full call,
    as ns_ops counts them: the set's accumulation (fused_set's plain
    version, the JAX package's sparse forward AD) on one element's
    stand-ins (form.nc local dofs per variable), with stand-ins for the
    coordinates of each qp (a coefficient that reads x, y or z differs
    at every qp). Cached per (form, scalars, alphas)."""
    from types import SimpleNamespace
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_ns import accumulate_density
    key = (form.source, form.h == 1.0, sc, None if stage is None
           else (stage.alpha_u, stage.alpha_t))
    if key in _SET_OPS:
        return _SET_OPS[key]
    gen = torch.Generator().manual_seed(97)

    def standin():
        return torch.rand(2, generator=gen, dtype=torch.float64) + 0.5
    steady = stage is None
    nv, nc, Q = len(form.variables), form.nc, tab.Q
    ue = [[standin() for _ in range(nc)] for _ in range(nv)]
    ud = [[0.0 if steady else standin() for _ in range(nc)]
          for _ in range(nv)]
    xy = [[standin() for _ in range(form.dim)] for _ in range(Q)]
    folded = SimpleNamespace(Q=Q, dim=form.dim, phi=tab.phi, grad=tab.grad,
                             wts=[1.0] * Q)
    with _OpCount() as count:
        accumulate_density(ue, ud, fs._density(form, lambda q: xy[q], sc),
                           folded, 1.0 if steady else stage.alpha_u,
                           0.0 if steady else stage.alpha_t, steady)
    _SET_OPS[key] = count.ops
    return count.ops


def set_work(N0, N1, dtype, form, ue, ud, sc, tab, geo, jac_idx,
             stage=None):
    """(bytes, flops) of one set_node_full call: the grids of all
    variables (and the u_dot ones) read once, the node residual and the
    varying Jacobian rows written once; set_ops per element, and the
    adds of the residual's scatter to the nodes."""
    nv = len(form.variables)
    nodes, E = (N0 + 1) * (N1 + 1), N0 * N1
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (nv * nodes * (3 if ud is not None else 2)
                   + len(jac_idx) * E)
    return nbytes, E * set_ops(form, tab, sc, stage) + nv * (4 * E - nodes)


def set_elem_work(dims, dtype, form, ue, ud, sc, tab, lat, geo, jac_idx,
                  stage=None):
    """(bytes, flops) of one set_elem_full call: the grids of all
    variables (and the u_dot ones) read once, the nd residual rows and
    the varying Jacobian rows written once; set_ops per element."""
    import math
    E, nd = math.prod(dims), len(form.variables) * len(lat.offsets)
    it = torch.finfo(dtype).bits // 8
    nbytes = it * (ue.numel() * (1 if ud is None else 2)
                   + (nd + len(jac_idx)) * E)
    return nbytes, E * set_ops(form, tab, sc, stage)


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


def run_deck(name, cfg, device, checks, mode, post=None):
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
    kernel never; mode None: no fused provider, no launch. An NS deck
    (mode "ns_full") launches ns_node_full once per fused res_and_jac
    call and no thermal kernel. A 3D hex or p2 deck ("elem_state",
    "elem_full") follows the thermal rule with the element kernels (B1)
    and launches no node kernel (B2); a 2D p1 deck no element kernel. A
    hex or p2 NS deck ("ns_elem_full") launches ns_elem_full once per
    fused res_and_jac call and no other kernel, and so does a module-set
    deck ("set_node_full") its generated kernel. post(problem, result),
    where given, returns more of the record, its "ok" joining the
    deck's."""
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
    if hasattr(fused, "_stage_cache"):
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
    extra = post(problem, result) if post else {}
    ok = (all(abs(e["L2"] - e["L2_ref"]) <= e["rtol"] * abs(e["L2_ref"])
              for e in errors) and extra.pop("ok", True)
          and u.shape == (problem.n_dof,) and bool(torch.isfinite(u).all())
          and u.device.type == torch.device(device).type)
    rec = {"phase": name, "n_dof": problem.n_dof, **extra,
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
            if mode in ("state", "elem_state") \
            and problem.solver_cfg.get("solver") == "transient" else 0
        want = {k: fused_calls + per_stage if k == mode else 0
                for k in launches}
    if launches != want or (mode is not None and fused_calls <= 0):
        raise SystemExit(f"phase {name}: Problem.run() launched {launches} "
                         f"for {fused_calls} fused res_and_jac calls and "
                         f"counts {result.counts}; expected {want}")
    return launches


def run_boussinesq(device):
    """The Boussinesq deck at beta = 1 and 0: max |ux| at beta = 1 equals
    the JAX package's to rtol 1e-8, and at beta = 0 it is below 1e-3 of
    that (no thermal forcing, as tests/test_flow.py:63-98 checks)."""
    maxu = {}

    def post(beta):
        def check(problem, result):
            dofs = torch.as_tensor(problem.disc.dofmap.all_dofs("ux"),
                                   device=result.u.device)
            m = maxu[beta] = float(result.u[dofs].abs().max())
            ok = abs(m - BOUSSINESQ_MAXU) <= 1e-8 * BOUSSINESQ_MAXU \
                if beta else m < 1e-3 * maxu[1.0]
            return {"max_ux": m, "max_ux_ref": BOUSSINESQ_MAXU if beta
                    else 1e-3 * maxu[1.0], "ok": ok}
        return check
    return [run_deck(f"boussinesq_gold_nx8_beta{b:g}", boussinesq_deck(8, b),
                     device, [], "set_node_full", post(b))
            for b in (1.0, 0.0)]


def set_sources():
    """The generated kernel sources of phases 3f and 3g's cases and the
    module-set decks (each deck's weak form at its size 4 on the CPU: the
    source does not depend on the mesh size), to build before any of them
    runs."""
    from mrhyde_tpu_torch.problem import Problem
    texts = [set_case(name, 1.0)[0].source for name in SET_KERNEL_CASES]
    texts += [set_elem_case(name, 1.0)[0].source
              for name in SET_ELEM_KERNEL_CASES]
    for build in [boussinesq_deck] + [b for b, *_ in SET_DECKS.values()] \
            + [b for b, *_ in SET_ELEM_DECKS.values()]:
        fused = Problem(build(4), device="cpu", dtype=torch.float64) \
            .assembler.fused_provider()
        texts.append(fused.form.source)
    return list(dict.fromkeys(texts))


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

    from concurrent.futures import ThreadPoolExecutor
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.ops import fused_p1 as fp
    t0 = time.perf_counter()
    texts = set_sources()
    t1 = time.perf_counter()
    # every nvcc at once: the csrc/*.cu libraries and the generated ones
    with ThreadPoolExecutor(1) as pool:
        gen = pool.submit(_build.build_generated, texts)
        _build.load_library()
        gen_logs = gen.result()

    def ptxas(log):
        return [ln for ln in log.splitlines() if "registers" in ln
                or "spill" in ln or "Compiling entry" in ln]
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "sources_s": t1 - t0, "generated": len(texts),
          "ptxas": ptxas(_build.build_log()),
          "ptxas_generated": {k: ptxas(v) for k, v in gen_logs.items()}})

    summary = phase_kernels(device)
    summary["ns_node_full"] = phase_ns_kernels(device)
    summary.update(phase_elem_kernels(device))
    advect = phase_advect_kernels(device)
    summary["ns_elem_full"] = phase_ns_elem_kernels(device)
    summary["set_node_full"] = phase_set_kernels(device)
    set_elem = phase_set_elem_kernels(device)
    summary["set_elem_full"] = set_elem["ns+cdr pspg+supg dirk22 stage 1"]

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
        run_deck("ns_channel_gold_nx50",
                 ns_deck(50, 10, {"use direct solver": True}), device,
                 [(0.0, v, g, 2e-5) for v, g in
                  (("ux", 0.00198075), ("pr", 0.0148536),
                   ("uy", 0.000169464))], "ns_full"),
        run_deck("ns_channel_direct_nx128",
                 ns_deck(128, 32, {"use direct solver": True,
                               "nonlinear TOL": 1e-8}), device,
                 [(0.0, v, g, 1e-4) for v, g in
                  zip(("ux", "pr", "uy"), NS_DIRECT_128)], "ns_full"),
    ] + [run_deck(f"ns_startup_dirk22_nx{n}", ns_startup_deck(n), device,
                  [(t, v, g, rtol) for t, ref in refs.items()
                   for v, g in zip(("ux", "pr", "uy"), ref)], "ns_full")
         for n, (rtol, refs) in NS_STARTUP.items()] + [
        run_deck("hex_gold_nx10", hex_deck(10), device,
                 [(0.0, "e", 0.0116656, 2e-5)], "elem_state"),
    ] + [
        run_deck(name, build(n), device, [(t, var, ref, 1e-4)], mode)
        for name, (build, n, t, var, mode, ref) in HEX_DECKS.items()] + [
        run_deck("p2_default_nx256",
                 p2_deck(256, solver={"nonlinear TOL": 1e-10}), device,
                 [(0.0, "e", P2_DEFAULT_L2, 1e-4)], "elem_state"),
        run_deck("p2_nonlinear_nx128",
                 p2_deck(128, "1.0 + e*e", SOURCE_NL,
                         {"nonlinear TOL": 1e-10, "Belos solver": "CG"}),
                 device, [(0.0, "e", P2_NL_L2, 1e-4)], "elem_full"),
    ] + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "ns_elem_full")
        for name, (build, n, rtol, refs) in NS_ELEM_DECKS.items()]
    advect_decks = [
        run_deck("cdr_gold_nx40", cdr_gold_deck(), device,
                 [(0.0, "c", 0.00101714, 2e-5)], "full")] + [
        run_deck(name, build(n), device, [(t, var, ref, 1e-4)], mode)
        for name, (build, n, t, var, mode, ref) in CDR_DECKS.items()]
    per_deck += advect_decks
    per_deck += run_boussinesq(device) + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "set_node_full")
        for name, (build, n, rtol, refs) in SET_DECKS.items()] + [
        run_deck(name, build(n), device,
                 [(t, v, g, rtol) for t, ref in refs.items()
                  for v, g in ref.items()], "set_elem_full")
        for name, (build, n, rtol, refs) in SET_ELEM_DECKS.items()]
    launches = {k: sum(d[k] for d in per_deck) for k in fp.LAUNCHES}
    advect_launches = {k: sum(d[k] for d in advect_decks)
                       for k in fp.LAUNCHES}
    emit({"phase": "launches", **launches})
    emit({"phase": "launches_advect", **advect_launches})
    if min(launches.values()) <= 0:
        raise SystemExit(f"a kernel of the main path never launched: "
                         f"{launches}")
    missing = [k for k in ("state", "full", "elem_state", "elem_full")
               if advect_launches[k] <= 0]
    if missing:
        raise SystemExit(f"the advection decks never launched {missing}: "
                         f"{advect_launches}")

    csrc = "mrhyde_tpu_torch/ops/csrc/"
    kernels = []
    # no single PyTorch call computes a node-scatter or an element-tile
    # assembly: library_ms is null for all eight. The four thermal kernels
    # report their advection (ADVECT) case and its launches beside: the
    # cdr and thermal-advection decks' share of `launches`; set_elem_full
    # reports every phase 3g case (f64, the divisible shape) beside.
    for name, mode, src, line in (
            ("thermal_node_state", "state", "fused_p1_thermal.cu", 1350),
            ("thermal_node_full", "full", "fused_p1_thermal.cu", 1350),
            ("ns_node_full", "ns_full", "fused_p1_ns.cu", 1350),
            ("thermal_elem_state", "elem_state", "fused_elem_thermal.cu",
             1303),
            ("thermal_elem_full", "elem_full", "fused_elem_thermal.cu",
             1303),
            ("ns_elem_full", "ns_elem_full", "fused_elem_ns.cu", 1303),
            ("set_node_full", "set_node_full", "set_node.cuh", 1350),
            ("set_elem_full", "set_elem_full", "set_elem.cuh", 1303)):
        rec = summary[name]
        kernels.append({"name": name, "route": "cuda", "source": csrc + src,
                        "replaces": f"mrhyde_tpu/ops/fused_p1.py:{line}",
                        "launches": launches[mode],
                        "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                        "plain_ms": rec["plain_ms"],
                        "bound_ms": rec["bound_ms"],
                        "bound_by": rec["bound_by"], "library_ms": None})
        if name in advect:
            a = advect[name]
            kernels[-1]["advect"] = {
                "case": a["case"], "shape": a["shape"],
                "launches": advect_launches[mode],
                "max_abs_err": a["max_abs_err"], "ms": a["ms"],
                "plain_ms": a["plain_ms"], "bound_ms": a["bound_ms"],
                "bound_by": a["bound_by"], "library_ms": None}
        if name == "set_elem_full":
            kernels[-1]["cases"] = [
                {k: c[k] for k in ("case", "mesh", "shape", "nd",
                                   "jac_rows", "max_abs_err", "ms",
                                   "plain_ms", "bound_ms", "bound_by")}
                for c in set_elem.values()]
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
