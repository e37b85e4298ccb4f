"""Linear solvers: dense direct for small systems, matrix-free Krylov
(GMRES, CG, BiCGStab) with a preconditioner otherwise.

The port of `mrhyde_tpu/solvers/linear.py`. `solve_dense` is
torch.linalg.solve on the densified Jacobian; the JAX package's
f32-LU-plus-refinement branch exists only because XLA:TPU has no f64 LU
and is not ported. Preconditioners come from solvers/precond.py by name,
or as `precond_fn` from a caller that holds an assembler-aware one (the
multigrid V-cycles of solvers/multigrid.py and solvers/amg.py).

solve_linear_info returns (x, KrylovInfo) so callers can CHECK
convergence.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.solvers.krylov import (KrylovInfo, bicgstab_fixed,
                                             gmres, pcg)
from mrhyde_tpu_torch.solvers.precond import build_preconditioner
from mrhyde_tpu_torch.utils.profiling import host_value, timed

__all__ = ["solve_linear", "solve_linear_info", "solve_dense", "solve_cg",
           "LinearOptions"]


class LinearOptions:
    """Per-system-class solver options (the reference's separate
    Belos / preconditioner option sets for state J, param J, boundary L2
    and volume L2). Build from the Solver sublist with `from_config`."""

    def __init__(self, method="gmres", tol=1e-10, maxiter=500, restart=40,
                 preconditioner="jacobi"):
        self.method = method
        self.tol = tol
        self.maxiter = maxiter
        self.restart = restart
        self.preconditioner = preconditioner

    @classmethod
    def from_config(cls, solver_cfg: dict, system: str = "state"):
        """system in {state, param, boundary L2, volume L2}; per-system
        overrides live in '<system> solver settings' sublists."""
        sc = dict(solver_cfg or {})
        sc.update(sc.get(f"{system} solver settings", {}) or {})
        method = "gmres"
        if bool(sc.get("use direct solver", False)):
            method = "direct"
        belos = str(sc.get("Belos solver", "Block GMRES")).lower()
        if "cg" in belos and method != "direct":
            method = "cg"
        prec = str(sc.get("preconditioner variant", "jacobi"))
        if not bool(sc.get("use preconditioner", True)):
            prec = "none"
        return cls(method=method,
                   tol=float(sc.get("linear TOL", 1e-10)),
                   maxiter=int(sc.get("max linear iters", 500)),
                   restart=int(sc.get("Belos block size",
                                      sc.get("restart", 40))),
                   preconditioner=prec)


def solve_dense(J, b):
    with timed("linear::dense_build"):
        A = J.dense()
    with timed("linear::lu"):
        return torch.linalg.solve(A, b)


def solve_cg(J, b, tol=1e-12, maxiter=1000, precond_variant="jacobi"):
    """(x, CG steps)."""
    M = build_preconditioner(J, precond_variant)
    return pcg(J.apply, b, M=M, tol=tol, maxiter=maxiter)


def _norm(v):
    return host_value(torch.linalg.norm(v))


@timed("linear::solve")
def solve_linear_info(J, b, method="gmres", tol=1e-10, maxiter=500,
                      restart=40, precond_variant="jacobi",
                      precond_fn=None):
    """Solve J x = b; returns (x, KrylovInfo). Direct, CG and BiCGStab
    solves report a computed (not assumed) residual. precond_fn
    overrides the variant for GMRES and BiCGStab (the multigrid
    preconditioners); CG builds its own from the variant."""
    if method == "direct":
        x = solve_dense(J, b)
        with timed("linear::check"):
            res, bn = _norm(b - J.apply(x)), _norm(b)
        ok = res <= max(1e-8 * (bn if bn > 0 else 1.0), 1e-30)
        return x, KrylovInfo(1, res, ok)
    if method == "cg":
        x, steps = solve_cg(J, b, tol=tol, maxiter=maxiter,
                            precond_variant=precond_variant)
        res, bn = _norm(b - J.apply(x)), _norm(b)
        ok = res <= tol * (bn if bn > 0 else 1.0) * 10
        return x, KrylovInfo(steps, res, ok)
    if method == "gmres":
        M = precond_fn if precond_fn is not None \
            else build_preconditioner(J, precond_variant)
        m = int(min(restart, maxiter))
        max_restarts = max(-(-maxiter // m), 1)
        return gmres(J.apply, b, m=m, tol=tol, max_restarts=max_restarts,
                     precond=M)
    if method == "bicgstab":
        # the Belos BiCGStab / TFQMR analog: a fixed number of iterations,
        # the residual computed afterwards
        M = precond_fn if precond_fn is not None \
            else build_preconditioner(J, precond_variant)
        iters = int(min(maxiter, 200))
        x = bicgstab_fixed(J.apply, b, iters=iters, precond=M)
        res, bn = _norm(b - J.apply(x)), _norm(b)
        ok = res <= tol * (bn if bn > 0 else 1.0) * 10
        return x, KrylovInfo(iters, res, ok)
    raise ValueError(f"unknown linear solver {method!r}")


def solve_linear(J, b, method="direct", tol=1e-12, maxiter=1000,
                 precond_variant="jacobi", restart=40):
    """Solve J x = b. method in {direct, cg, gmres, bicgstab}."""
    x, _ = solve_linear_info(J, b, method=method, tol=tol, maxiter=maxiter,
                             restart=restart,
                             precond_variant=precond_variant)
    return x
