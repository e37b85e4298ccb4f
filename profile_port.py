"""Profile of the PyTorch/CUDA port's hot loops on one card.

    python3 profile_port.py [--out DIR] [--n-state 1024] [--n-full 512]
                            [--cg-iters 200] [--device cuda]

Runs torch.profiler over four pieces of the steady thermal main path and
prints one JSON line each, with the wall time (host clock, ending in a
synchronize), the device busy time (sum of the device events' spans) and
their ratio, and the number of device events:

  assembly_state  5 x Assembler.res_and_jac, kappa = 1, n_state^2
                  (thermal_node_state)
  assembly_full   5 x res_and_jac, kappa = 1 + e*e, n_full^2
                  (thermal_node_full and its coefficient pre-pass)
  apply           20 x BlockJacobian.apply of that Jacobian, and the
                  CUDA-event median of 20 of it and of
                  Assembler.matfree_apply_fn
  cg              cg_iters iterations of Jacobi-preconditioned CG on it

With --out, each piece's key_averages table goes to DIR/<piece>.txt.
The decks are chip_smoke.py's, with the state at the deck's initial
guess (assembly_state) or at a seeded random interior state.
"""

import argparse
import json
import os
import statistics
import time

import torch

from chip_smoke import SOURCE_NL, deck


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def profiled(name, fn, device, out_dir, per=1):
    """Runs fn() once to warm up, then once under torch.profiler, and
    prints wall and device-busy times (per `per` repetitions)."""
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
    print(json.dumps({
        "piece": name, "per": per, "wall_ms": wall_ms / per,
        "device_busy_ms": busy_ms / per,
        "device_busy_share": busy_ms / wall_ms if wall_ms else 0.0,
        "device_events": len(dev) / per}), flush=True)
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--n-state", type=int, default=1024)
    ap.add_argument("--n-full", type=int, default=512)
    ap.add_argument("--cg-iters", type=int, default=200)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args()
    device = torch.device(args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)

    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.krylov import pcg
    from mrhyde_tpu_torch.solvers.precond import build_preconditioner

    def setup(cfg):
        p = Problem(cfg, device=device)
        return p, TimeCoeffs.steady(p.n_dof, dtype=p.dtype, device=device)

    p, tc = setup(deck(args.n_state))
    u = p.initial_state()

    def assemble_state():
        for _ in range(5):
            p.assembler.res_and_jac(u, tc)
    profiled("assembly_state", assemble_state, device, args.out, per=5)

    p, tc = setup(deck(args.n_full, "1.0 + e*e", SOURCE_NL))
    gen = torch.Generator(device=device).manual_seed(1234)
    u = p.bcs.apply(torch.rand(p.n_dof, generator=gen, device=device,
                               dtype=p.dtype), 0.0)

    def assemble_full():
        for _ in range(5):
            p.assembler.res_and_jac(u, tc)
    profiled("assembly_full", assemble_full, device, args.out, per=5)

    r, J = p.assembler.res_and_jac(u, tc)

    def apply20():
        for _ in range(20):
            J.apply(r)
    profiled("apply", apply20, device, args.out, per=20)
    if device.type == "cuda":
        matfree = p.assembler.matfree_apply_fn(J)
        err = float((matfree(r) - J.apply(r)).abs().max())
        print(json.dumps({
            "piece": "apply_vs_matfree", "n_dof": p.n_dof,
            "apply_ms": event_ms(lambda: J.apply(r)),
            "matfree_apply_ms": event_ms(lambda: matfree(r)),
            "max_abs_diff": err}), flush=True)

    M = build_preconditioner(J, "jacobi")
    profiled("cg", lambda: pcg(J.apply, r, M=M, tol=0.0,
                               maxiter=args.cg_iters),
             device, args.out, per=args.cg_iters)


if __name__ == "__main__":
    main()
