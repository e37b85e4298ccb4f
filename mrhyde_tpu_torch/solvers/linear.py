"""Linear solvers: dense direct for small systems, matrix-free Krylov
(GMRES, CG) with a preconditioner otherwise.

The port of `mrhyde_tpu/solvers/linear.py`. `solve_dense` is
torch.linalg.solve on the densified Jacobian; the JAX package's
f32-LU-plus-refinement branch exists only because XLA:TPU has no f64 LU
and is not ported. BiCGStab is not ported yet (ROADMAP A5).

solve_linear_info returns (x, KrylovInfo) so callers can CHECK
convergence.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.solvers.krylov import KrylovInfo, gmres, pcg
from mrhyde_tpu_torch.solvers.precond import build_preconditioner

__all__ = ["solve_linear", "solve_linear_info", "solve_dense", "solve_cg"]


def solve_dense(J, b):
    return torch.linalg.solve(J.dense(), b)


def solve_cg(J, b, tol=1e-12, maxiter=1000, precond_variant="jacobi"):
    """(x, CG steps)."""
    M = build_preconditioner(J, precond_variant)
    return pcg(J.apply, b, M=M, tol=tol, maxiter=maxiter)


def _norm(v):
    return float(torch.linalg.norm(v))


def solve_linear_info(J, b, method="gmres", tol=1e-10, maxiter=500,
                      restart=40, precond_variant="jacobi"):
    """Solve J x = b; returns (x, KrylovInfo). Direct and CG solves
    report a computed (not assumed) residual."""
    if method == "direct":
        x = solve_dense(J, b)
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
        M = build_preconditioner(J, precond_variant)
        m = int(min(restart, maxiter))
        max_restarts = max(-(-maxiter // m), 1)
        return gmres(J.apply, b, m=m, tol=tol, max_restarts=max_restarts,
                     precond=M)
    if method == "bicgstab":
        raise NotImplementedError(
            "BiCGStab is not ported to mrhyde_tpu_torch yet (ROADMAP A5)")
    raise ValueError(f"unknown linear solver {method!r}")


def solve_linear(J, b, method="direct", tol=1e-12, maxiter=1000,
                 precond_variant="jacobi", restart=40):
    """Solve J x = b. method in {direct, cg, gmres}."""
    x, _ = solve_linear_info(J, b, method=method, tol=tol, maxiter=maxiter,
                             restart=restart,
                             precond_variant=precond_variant)
    return x
