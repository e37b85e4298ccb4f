"""Profile of the PyTorch/CUDA port's hot loops on one card.

    python3 profile_port.py [--out DIR] [--n-state 1024] [--n-full 512]
                            [--cg-iters 200] [--device cuda]
    python3 profile_port.py --split [--n-full 512] [--device cuda]
    python3 profile_port.py --ns [--n-ns 512] [--out DIR] [--device cuda]
    python3 profile_port.py --hex [--out DIR] [--device cuda]
    python3 profile_port.py --ns-elem [--out DIR] [--device cuda]
    python3 profile_port.py --set [--out DIR] [--device cuda]

Runs torch.profiler over pieces of the thermal main path, steady and
transient, and prints one JSON line each, with the wall time (host
clock, ending in a synchronize), the device busy time (sum of the device
events' spans) and their ratio, and the number of device events:

  assembly_state  5 x Assembler.res_and_jac, kappa = 1, n_state^2
                  (thermal_node_state)
  assembly_state_transient  the same at one transient stage (DIRK-2,2
                  stage-1 alphas, betas from a seeded state): what each
                  Newton iteration of a stage pays (coord part cached)
  stage_state_transient  5 x a new stage's first res_and_jac: the coord
                  part recomputed each time (plain-torch source term and
                  Jacobian rows, two state-kernel launches on the beta
                  grids)
  assembly_full   5 x res_and_jac, kappa = 1 + e*e, n_full^2
                  (thermal_node_full and its coefficient pre-pass)
  assembly_full_transient  the same at one transient stage
  apply_state, apply_full  one Jacobian product of the n_state^2
                  kappa = 1 Jacobian (constant rows) and of the n_full^2
                  kappa = 1 + e*e one (16 varying rows) three ways:
                  CUDA-event medians of 20 of the SoA rows, the AoS
                  einsum and Assembler.matfree_apply_fn
  apply           20 x BlockJacobian.apply of the n_full^2 Jacobian
  cg              cg_iters iterations of Jacobi-preconditioned CG on it

With --out, each piece's key_averages table goes to DIR/<piece>.txt.
The decks are chip_smoke.py's, with the state at the deck's initial
guess (assembly_state) or at a seeded random interior state.

--split runs no profiler. It builds the kernels, then solves
chip_smoke.py's two n_full^2 kappa = 1 + e*e decks (steady nonlinear,
transient BDF2) twice each in one process, and prints one `split` line
per solve: its wall time and the host time (each call ending in a
synchronize) spent in the Krylov solves, in the fused res_and_jac calls
and in the general residuals of Newton's line search. The first solve
of the first deck carries the process's first-use costs.

--ns profiles the Navier-Stokes path (chip_smoke.py's channel decks):

  ns_apply        at a seeded DIRK-2,2 stage of the n_ns x n_ns/4
                  start-up deck, the CUDA-event medians of 20 of one
                  Jacobian product three ways: the SoA rows
                  (BlockJacobian.soa_products, ~300 eager ops at nd = 12),
                  the AoS einsum the solvers use (BlockJacobian.apply),
                  and Assembler.matfree_apply_fn; and the one-time AoS
                  build
  ns_assembly_stage  5 x res_and_jac at that stage (ns_node_full)
  ns_gmres_cycle  one GMRES(40) cycle with Jacobi on that Jacobian
  split           the 128x32 direct deck and the start-up deck, each
                  solve split as --split does (linear solves, fused
                  res_and_jac calls, line-search residuals, the rest)

--hex profiles the element-kernel (B1) path at chip_smoke.py's hex and
p2 deck sizes, each at a seeded random state:

  hex_state_nx96_apply  one Jacobian product of the 96^3 kappa = 1 hex
                  Jacobian (64 constant rows) three ways, as apply_state
  hex_state_nx96_assembly  5 x res_and_jac of that deck
                  (thermal_elem_state and the pad+sum of its 8 rows)
  hex_state_nx96_gmres_cycle  one GMRES(40) cycle with Jacobi on that
                  Jacobian
  hex_full_nx64_apply, hex_full_nx64_assembly  the same for the 64^3
                  kappa = 1 + e*e deck (thermal_elem_full and its
                  coefficient pre-pass; 64 varying rows)
  p2_state_nx256_apply, p2_state_nx256_assembly  the same for the 256^2
                  p2 deck (81 constant rows; the scatter on the fine
                  lattice)

--ns-elem profiles the B1 Navier-Stokes path (chip_smoke.py's
NS_ELEM_DECKS start-ups, hex 64x16x16 and p2 128x32), each at a seeded
DIRK-2,2 stage:

  *_apply         one Jacobian product three ways, as apply_state
  *_assembly_stage  5 x res_and_jac (ns_elem_full, the scatter of its
                  residual rows, the Jacobian's rows), with kernel_ms:
                  ns_elem_full's device time per call

--set profiles the module-set path (chip_smoke.py's SET_DECKS start-ups,
the heated cavity 128^2 and NS + cdr 256x64), each at a seeded DIRK-2,2
stage:

  *_apply         one Jacobian product three ways, as apply_state
  *_assembly_stage  5 x res_and_jac (one set_node_full launch each), with
                  kernel_ms: set_node_full's device time per call
  *_gmres_cycle   one GMRES(40) cycle with Jacobi on that Jacobian

and then the B1 module-set decks (chip_smoke.py's SET_ELEM_DECKS), each
at its own size and at a seeded state, in the call chip_smoke.py times
as its `assembly_ms` (assembly_tc: a BWE stage of the deck's step for
the start-up, a steady call for the others):

  <deck>_assembly  5 x res_and_jac (one set_elem_full launch each), with
                  kernel_ms: set_elem_full's device time per call, and
                  unprofiled_wall_ms: the median host time of one call
                  without the profiler (5 calls, each ending in a
                  synchronize)
"""

import argparse
import json
import os
import statistics
import time

import torch

from chip_smoke import (SET_ELEM_DECKS, SOURCE3_NL, assembly_tc,
                        bdf2_nonlinear_deck, cavity_deck, deck, hex_deck,
                        nonlinear_deck, ns_cdr_deck, ns_deck,
                        ns_elem_startup_deck, ns_startup_deck, p2_deck)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def profiled(name, fn, device, out_dir, per=1, kernel=None, extra=None):
    """Runs fn() once to warm up, then once under torch.profiler, and
    prints wall and device-busy times (per `per` repetitions); with
    `kernel`, also the device time and count of the events whose name
    holds it; `extra` joins the record."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    sync(device)
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    rec = {"piece": name, "per": per, "wall_ms": wall_ms / per,
           "device_busy_ms": busy_ms / per,
           "device_busy_share": busy_ms / wall_ms if wall_ms else 0.0,
           "device_events": len(dev) / per}
    if kernel:
        mine = [e for e in dev if kernel in e.name]
        rec.update(kernel=kernel, kernel_events=len(mine) / per,
                   kernel_ms=sum(e.time_range.elapsed_us()
                                 for e in mine) / 1e3 / per)
    rec.update(extra or {})
    print(json.dumps(rec), flush=True)
    if out_dir:
        sort = "self_cuda_time_total" if device.type == "cuda" \
            else "self_cpu_time_total"
        with open(os.path.join(out_dir, f"{name}.txt"), "w") as f:
            f.write(prof.key_averages().table(sort_by=sort, row_limit=40))


def event_ms(fn, reps=20):
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


def apply_timings(name, asm, J, v, device):
    """One line with the CUDA-event medians of 20 of one Jacobian product
    three ways: the SoA rows (BlockJacobian.soa_products), the AoS
    einsum and Assembler.matfree_apply_fn, which one BlockJacobian.apply
    takes, and the one-time AoS build."""
    from mrhyde_tpu_torch.assembly.assembler import BlockJacobian

    def soa_apply(x):
        xm = torch.where(J.fixed, 0.0, x)
        return torch.where(J.fixed, x, J._gather_sum(J._soa_mv(xm)))
    matfree = asm.matfree_apply_fn(J)
    sync(device)
    t0 = time.perf_counter()
    aos = J.aos()
    sync(device)
    build_ms = (time.perf_counter() - t0) * 1e3
    Ja = BlockJacobian(vol=aos, vol_lids=J.vol_lids, fixed=J.fixed,
                       inc=J.inc)
    ref = Ja.apply(v)
    rec = {"piece": name, "n_dof": int(v.shape[0]),
           "nd": int(J.vol_lids.shape[1]),
           "n_elem": int(J.vol_lids.shape[0]),
           "varying_rows": sum(r is not None and r.dim() > 0
                               for r in J.vol_soa),
           "apply_takes": "aos" if J.soa_varies
           or J.vol_lids.shape[1] > 4 else "soa",
           "aos_build_ms": build_ms,
           "max_abs_diff_soa": float((soa_apply(v) - ref).abs().max()),
           "max_abs_diff_matfree": float((matfree(v) - ref).abs().max())}
    if device.type == "cuda":
        rec.update(soa_ms=event_ms(lambda: soa_apply(v)),
                   aos_ms=event_ms(lambda: Ja.apply(v)),
                   matfree_ms=event_ms(lambda: matfree(v)))
    print(json.dumps(rec), flush=True)


def timed(fn, device, acc):
    """fn wrapped to add its calls and host seconds (ending in a
    synchronize) to acc = [calls, seconds]."""
    def run(*a, **k):
        sync(device)
        t0 = time.perf_counter()
        out = fn(*a, **k)
        sync(device)
        acc[0] += 1
        acc[1] += time.perf_counter() - t0
        return out
    return run


def split_solves(device, decks, runs=(1, 2)):
    """Where the time of each deck's solve goes (--split, --ns): decks is
    a list of (name, cfg), each solved once per run."""
    from mrhyde_tpu_torch.ops import _build
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers import nonlinear
    if device.type == "cuda":
        t0 = time.perf_counter()
        _build.load_library()
        print(json.dumps({"piece": "build",
                          "seconds": time.perf_counter() - t0}), flush=True)
    solve_linear_info = nonlinear.solve_linear_info
    for name, cfg in decks:
        for run in runs:
            p = Problem(cfg, device=device)
            asm = p.assembler
            acc = {k: [0, 0.0] for k in ("krylov", "res_and_jac",
                                          "residual")}
            nonlinear.solve_linear_info = timed(solve_linear_info, device,
                                                acc["krylov"])
            asm.res_and_jac = timed(asm.res_and_jac, device,
                                    acc["res_and_jac"])
            asm.residual = timed(asm.residual, device, acc["residual"])
            sync(device)
            t0 = time.perf_counter()
            result = p.run()
            sync(device)
            wall = time.perf_counter() - t0
            nonlinear.solve_linear_info = solve_linear_info
            rec = {"piece": "split", "deck": name, "run": run,
                   "n_dof": p.n_dof, **result.counts, "solve_s": wall}
            for k, (calls, secs) in acc.items():
                rec[f"{k}_calls"], rec[f"{k}_s"] = calls, secs
            rec["other_s"] = wall - sum(v[1] for v in acc.values())
            rec["krylov_ms_per_iter"] = (1e3 * acc["krylov"][1]
                                         / max(result.counts["linear_iters"],
                                               1))
            print(json.dumps(rec), flush=True)


def ns_pieces(device, n, out_dir):
    """--ns: the NS Jacobian product three ways, a stage's assembly and a
    GMRES cycle under the profiler, then the split of the NS solves."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.krylov import gmres
    from mrhyde_tpu_torch.solvers.precond import build_preconditioner
    p = Problem(ns_startup_deck(n), device=device)
    asm = p.assembler
    gen = torch.Generator(device=device).manual_seed(1234)
    u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                               dtype=p.dtype) - 0.5, 0.0)
    # DIRK-2,2 stage 1 at dt = 0.01, betas from the state
    tc = TimeCoeffs(0.5, 0.5 * u, 200.0, -200.0 * u, 0.01, 0.01)
    r, J = asm.res_and_jac(u, tc)
    apply_timings("ns_apply", asm, J, r, device)
    profiled("ns_assembly_stage",
             lambda: [asm.res_and_jac(u, tc) for _ in range(5)], device,
             out_dir, per=5)
    M = build_preconditioner(J, "jacobi")
    profiled("ns_gmres_cycle",
             lambda: gmres(J.apply, r, m=40, tol=0.0, max_restarts=1,
                           precond=M), device, out_dir, per=40)
    split_solves(device, [
        ("ns_channel_direct_nx128", ns_deck(128, 32, {
            "use direct solver": True, "nonlinear TOL": 1e-8})),
        (f"ns_startup_dirk22_nx{n}", ns_startup_deck(n))], runs=(1,))


def hex_pieces(device, out_dir):
    """--hex: the B1 decks' Jacobian products three ways, assembly and a
    GMRES cycle under the profiler."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.krylov import gmres
    from mrhyde_tpu_torch.solvers.precond import build_preconditioner
    gen = torch.Generator(device=device).manual_seed(1234)

    def pieces(tag, cfg, gmres_cycle=False):
        p = Problem(cfg, device=device)
        asm = p.assembler
        tc = TimeCoeffs.steady(p.n_dof, dtype=p.dtype, device=device)
        u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                                   dtype=p.dtype) - 0.5, 0.0)
        r, J = asm.res_and_jac(u, tc)
        apply_timings(f"{tag}_apply", asm, J, r, device)
        profiled(f"{tag}_assembly",
                 lambda: [asm.res_and_jac(u, tc) for _ in range(5)],
                 device, out_dir, per=5)
        if gmres_cycle:
            M = build_preconditioner(J, "jacobi")
            profiled(f"{tag}_gmres_cycle",
                     lambda: gmres(J.apply, r, m=40, tol=0.0,
                                   max_restarts=1, precond=M),
                     device, out_dir, per=40)
    pieces("hex_state_nx96", hex_deck(96), gmres_cycle=True)
    pieces("hex_full_nx64", hex_deck(64, "1.0 + e*e", SOURCE3_NL))
    pieces("p2_state_nx256", p2_deck(256))


def ns_elem_pieces(device, out_dir):
    """--ns-elem: the B1 NS start-up decks at a seeded DIRK-2,2 stage:
    the Jacobian product three ways, and the assembly under the profiler
    with ns_elem_full's own device time."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    gen = torch.Generator(device=device).manual_seed(1234)
    for tag, mesh, n in (("ns3d_startup_nx64", "hex", 64),
                         ("p2ns_startup_nx128", "p2", 128)):
        p = Problem(ns_elem_startup_deck(mesh, n), device=device)
        asm = p.assembler
        u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                                   dtype=p.dtype) - 0.5, 0.0)
        # DIRK-2,2 stage 1 at dt = 0.01, betas from the state
        tc = TimeCoeffs(0.5, 0.5 * u, 200.0, -200.0 * u, 0.01, 0.01)
        r, J = asm.res_and_jac(u, tc)
        apply_timings(f"{tag}_apply", asm, J, r, device)
        profiled(f"{tag}_assembly_stage",
                 lambda: [asm.res_and_jac(u, tc) for _ in range(5)],
                 device, out_dir, per=5, kernel="ns_elem_full")


def set_pieces(device, out_dir):
    """--set: the module-set start-up decks at a seeded DIRK-2,2 stage:
    the Jacobian product three ways, the assembly under the profiler with
    set_node_full's own device time, and a GMRES cycle."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.krylov import gmres
    from mrhyde_tpu_torch.solvers.precond import build_preconditioner
    gen = torch.Generator(device=device).manual_seed(1234)
    for tag, cfg in (("cavity_nx128", cavity_deck(128)),
                     ("ns_cdr_nx256", ns_cdr_deck(256))):
        p = Problem(cfg, device=device)
        asm = p.assembler
        u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                                   dtype=p.dtype) - 0.5, 0.0)
        # DIRK-2,2 stage 1 at dt = 0.01, betas from the state
        tc = TimeCoeffs(0.5, 0.5 * u, 200.0, -200.0 * u, 0.01, 0.01)
        r, J = asm.res_and_jac(u, tc)
        apply_timings(f"{tag}_apply", asm, J, r, device)
        profiled(f"{tag}_assembly_stage",
                 lambda: [asm.res_and_jac(u, tc) for _ in range(5)],
                 device, out_dir, per=5, kernel="set_node_full")
        M = build_preconditioner(J, "jacobi")
        profiled(f"{tag}_gmres_cycle",
                 lambda: gmres(J.apply, r, m=40, tol=0.0, max_restarts=1,
                               precond=M),
                 device, out_dir, per=40)
    for name, (build, n, _rtol, _refs) in SET_ELEM_DECKS.items():
        p = Problem(build(n), device=device)
        asm = p.assembler
        u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                                   dtype=p.dtype) - 0.5, 0.0)
        tc = assembly_tc(p, u, 0.0)
        asm.res_and_jac(u, tc)
        walls = []
        for _ in range(5):
            sync(device)
            t0 = time.perf_counter()
            asm.res_and_jac(u, tc)
            sync(device)
            walls.append((time.perf_counter() - t0) * 1e3)
        profiled(f"{name}_assembly",
                 lambda: [asm.res_and_jac(u, tc) for _ in range(5)],
                 device, out_dir, per=5, kernel="set_elem_full",
                 extra={"unprofiled_wall_ms": statistics.median(walls),
                        "n_dof": p.n_dof})


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--n-state", type=int, default=1024)
    ap.add_argument("--n-full", type=int, default=512)
    ap.add_argument("--cg-iters", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--ns", action="store_true")
    ap.add_argument("--n-ns", type=int, default=512)
    ap.add_argument("--hex", action="store_true")
    ap.add_argument("--ns-elem", action="store_true")
    ap.add_argument("--set", action="store_true")
    args = ap.parse_args()
    device = torch.device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.split:
        n = args.n_full
        split_solves(device, [(f"nonlinear_nx{n}", nonlinear_deck(n)),
                              (f"bdf2_nonlinear_nx{n}",
                               bdf2_nonlinear_deck(n))])
        return
    if args.ns:
        ns_pieces(device, args.n_ns, args.out)
        return
    if args.hex:
        hex_pieces(device, args.out)
        return
    if args.ns_elem:
        ns_elem_pieces(device, args.out)
        return
    if args.set:
        set_pieces(device, args.out)
        return

    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.krylov import pcg
    from mrhyde_tpu_torch.solvers.precond import build_preconditioner

    def setup(cfg):
        p = Problem(cfg, device=device)
        return p, TimeCoeffs.steady(p.n_dof, dtype=p.dtype, device=device)

    gen = torch.Generator(device=device).manual_seed(1234)

    def seeded_state(p):
        return p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                                      dtype=p.dtype), 0.0)

    def stage(u):
        # DIRK-2,2 stage 1 at dt = 0.05, betas from the state
        return TimeCoeffs(0.5, 0.5 * u, 40.0, -40.0 * u, 0.3, 0.05)

    def repeat(p, u, tc_fn):
        def run():
            for _ in range(5):
                p.assembler.res_and_jac(u, tc_fn())
        return run

    p, tc = setup(deck(args.n_state))
    u = p.initial_state()
    apply_timings("apply_state", p.assembler,
                  p.assembler.res_and_jac(u, tc)[1], u, device)
    profiled("assembly_state", repeat(p, u, lambda: tc), device, args.out,
             per=5)
    u = seeded_state(p)
    tcs = stage(u)
    profiled("assembly_state_transient", repeat(p, u, lambda: tcs), device,
             args.out, per=5)
    profiled("stage_state_transient", repeat(p, u, lambda: stage(u)),
             device, args.out, per=5)

    p, tc = setup(nonlinear_deck(args.n_full))
    u = seeded_state(p)
    tcs = stage(u)
    profiled("assembly_full_transient", repeat(p, u, lambda: tcs), device,
             args.out, per=5)
    profiled("assembly_full", repeat(p, u, lambda: tc), device, args.out,
             per=5)

    r, J = p.assembler.res_and_jac(u, tc)

    def apply20():
        for _ in range(20):
            J.apply(r)
    profiled("apply", apply20, device, args.out, per=20)
    apply_timings("apply_full", p.assembler, J, r, device)

    M = build_preconditioner(J, "jacobi")
    profiled("cg", lambda: pcg(J.apply, r, M=M, tol=0.0,
                               maxiter=args.cg_iters),
             device, args.out, per=args.cg_iters)


if __name__ == "__main__":
    main()
