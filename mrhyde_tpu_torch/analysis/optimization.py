"""PDE-constrained optimization: an L-BFGS-B style bound-constrained
solver.

A copy of the JAX package's numpy-only `mrhyde_tpu/analysis/
optimization.py` (the reference's ROL adapters, analysisManager.cpp:
417-630 ROLSolve, MrHyDE_Objective.hpp): value = the forward objective,
gradient = the adjoint through the differentiable forward
(analysis/forward_ad.py), with a projected L-BFGS two-loop recursion,
Armijo backtracking and optional bounds, plus the finite-difference
gradient check ROL performs (checkGradient).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["lbfgs_solve", "OptResult", "check_gradient"]


@dataclass
class OptResult:
    x: np.ndarray
    value: float
    iterations: int
    converged: bool
    history: list = field(default_factory=list)


def _project(x, lo, hi):
    if lo is None:
        return x
    return np.clip(x, lo, hi)


def lbfgs_solve(value_and_grad, x0, *, bounds=None, maxiter=100,
                gtol=1e-8, ftol=1e-14, memory=10, verbose=0) -> OptResult:
    """Projected L-BFGS with Armijo backtracking.

    value_and_grad(x: np.ndarray) -> (float, np.ndarray).
    bounds: optional (lo, hi) arrays for box constraints.
    """
    lo, hi = (bounds if bounds is not None else (None, None))
    x = _project(np.asarray(x0, dtype=float).copy(), lo, hi)
    f, g = value_and_grad(x)
    f, g = float(f), np.asarray(g, dtype=float)
    S, Y = [], []
    history = [(f, float(np.linalg.norm(g)))]
    it = 0
    converged = False
    while it < maxiter:
        gnorm = np.linalg.norm(g)
        if gnorm < gtol:
            converged = True
            break
        # two-loop recursion
        q = g.copy()
        alphas = []
        for s, y in zip(reversed(S), reversed(Y)):
            rho = 1.0 / max(y @ s, 1e-300)
            a = rho * (s @ q)
            alphas.append((a, rho, s, y))
            q -= a * y
        if S:
            y, s = Y[-1], S[-1]
            q *= (s @ y) / max(y @ y, 1e-300)
        for (a, rho, s, y) in reversed(alphas):
            b = rho * (y @ q)
            q += (a - b) * s
        d = -q
        if d @ g > 0:   # not a descent direction, reset
            d = -g
            S, Y = [], []
        # Armijo backtracking with projection
        step = 1.0
        ok = False
        for _ in range(30):
            xn = _project(x + step * d, lo, hi)
            fn, gn = value_and_grad(xn)
            fn = float(fn)
            if fn <= f + 1e-4 * (g @ (xn - x)):
                ok = True
                break
            step *= 0.5
        if not ok:
            break
        gn = np.asarray(gn, dtype=float)
        s_vec, y_vec = xn - x, gn - g
        if s_vec @ y_vec > 1e-12 * np.linalg.norm(s_vec) \
                * np.linalg.norm(y_vec):
            S.append(s_vec)
            Y.append(y_vec)
            if len(S) > memory:
                S.pop(0)
                Y.pop(0)
        if abs(fn - f) < ftol * max(1.0, abs(f)):
            x, f, g = xn, fn, gn
            converged = True
            history.append((f, float(np.linalg.norm(g))))
            break
        x, f, g = xn, fn, gn
        history.append((f, float(np.linalg.norm(g))))
        if verbose:
            print(f"LBFGS iter {it}: f = {f:.8e}, |g| = {history[-1][1]:.3e}")
        it += 1
    return OptResult(x=x, value=f, iterations=it, converged=converged,
                     history=history)


def check_gradient(value_and_grad, x0, *, n_directions=1, steps=None,
                   seed=0, verbose=0):
    """ROL-style FD gradient check: directional derivative vs FD at a
    ladder of step sizes. Returns the best relative error per direction.
    """
    steps = steps if steps is not None else [10.0 ** (-k)
                                             for k in range(1, 9)]
    rng = np.random.RandomState(seed)
    x0 = np.asarray(x0, dtype=float)
    f0, g0 = value_and_grad(x0)
    f0 = float(f0)
    g0 = np.asarray(g0, dtype=float)
    best = []
    for _ in range(n_directions):
        d = rng.normal(size=x0.shape)
        d /= np.linalg.norm(d)
        gd = float(g0 @ d)
        errs = []
        for h in steps:
            fp, _ = value_and_grad(x0 + h * d)
            fm, _ = value_and_grad(x0 - h * d)
            fd = (float(fp) - float(fm)) / (2 * h)
            errs.append(abs(fd - gd) / max(abs(gd), 1e-14))
            if verbose:
                print(f"  h={h:.1e}  fd={fd:.10e}  ad={gd:.10e}  "
                      f"rel={errs[-1]:.3e}")
        best.append(min(errs))
    return best
