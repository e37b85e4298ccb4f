"""Preconditioners for the matrix-free Krylov solvers.

The Jacobi part of the JAX package's `mrhyde_tpu/solvers/precond.py`:
each function takes a BlockJacobian and returns `v -> M(v)`, the RIGHT
preconditioner of solvers/krylov.py. Chebyshev, element-Schwarz,
fieldsplit SIMPLE and the multigrid variants are not ported yet
(ROADMAP A5) and raise.
"""

from __future__ import annotations

__all__ = ["build_preconditioner", "jacobi_precond"]


def jacobi_precond(J):
    dinv = 1.0 / J.diag()
    return lambda v: dinv * v


def build_preconditioner(J, variant: str = "jacobi"):
    """Deck-facing factory ('preconditioner variant' key)."""
    v = (variant or "jacobi").strip().lower()
    if v in ("none", "identity"):
        return lambda x: x
    if v in ("jacobi", "relaxation", "point relaxation"):
        return jacobi_precond(J)
    if v in ("chebyshev", "schwarz", "block jacobi", "block-jacobi", "ebe",
             "multigrid", "mg", "amg"):
        raise NotImplementedError(
            f"preconditioner {variant!r} is not ported to mrhyde_tpu_torch "
            "yet (ROADMAP A5)")
    raise ValueError(f"unknown preconditioner variant {variant!r}")
