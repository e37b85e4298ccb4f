"""Restarted GMRES(m) with Givens rotations, and the PCG of the JAX
package's `cg` solve.

`gmres` ports `mrhyde_tpu/solvers/krylov.py` (`_gmres_cycle`, `gmres`):
right-preconditioned, so the Givens-rotated rhs gives the true residual
norm each Arnoldi step and the cycle exits as soon as it meets the
target. The vectors stay on the device; the (m+1)-long Hessenberg
column and its rotations are host scalars, which costs one device sync
per Arnoldi step and keeps the loop free of data-dependent device
control flow.

`pcg` is `jax.scipy.sparse.linalg.cg`'s algorithm (which the JAX
package's `solve_cg` calls), with its stopping rule
||r|| <= max(tol*||b||, atol) and x0 = 0.

`pcg_reference` is the JAX package's reference-rule diagonal PCG of the
fully explicit mass solve.

`gmres_fixed` and `bicgstab_fixed` run a fixed iteration count with no
data-dependent exit (the JAX package's `lax.scan` loops as Python loops):
their scalars stay 0-d tensors on the device, so no iteration waits for
the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from mrhyde_tpu_torch.utils.profiling import count, host_value, timed

__all__ = ["gmres", "gmres_fixed", "bicgstab_fixed", "pcg",
           "pcg_reference", "KrylovInfo"]


class KrylovInfo(NamedTuple):
    """Solver report (host values)."""
    iters: int             # matvecs in the Krylov iteration
    resnorm: float         # final (estimated) residual norm
    converged: bool        # resnorm <= max(tol*||b||, atol)


def _identity(v):
    return v


def _gmres_cycle(matvec, M, x0, r0, target, m):
    """One GMRES(m) Arnoldi cycle: runs until the rotated-rhs residual
    estimate drops below `target` or m steps elapse.
    Returns (x1, resnorm, steps)."""
    n = r0.shape[0]
    beta = host_value(torch.linalg.norm(r0))
    scale = beta if beta > 0 else 1.0
    V = torch.empty((m + 1, n), dtype=r0.dtype, device=r0.device)
    V[0] = r0 / scale
    R = [[0.0] * m for _ in range(m)]
    cs, sn = [0.0] * m, [0.0] * m
    g = [0.0] * (m + 1)
    g[0] = beta
    j, res = 0, beta
    while j < m and res > target:
        w = matvec(M(V[j]))
        # classical Gram-Schmidt against the j+1 basis vectors so far
        h = V[:j + 1] @ w
        w = w - h @ V[:j + 1]
        nrm = torch.linalg.norm(w)
        hcol = host_value(torch.cat([h, nrm[None]]))
        V[j + 1] = w / (hcol[j + 1] if hcol[j + 1] > 0 else 1.0)
        # apply the j previous rotations to the new column
        for i in range(j):
            a = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i] = a
        # new rotation annihilating hcol[j+1]
        hj, hj1 = hcol[j], hcol[j + 1]
        denom = math.sqrt(hj * hj + hj1 * hj1)
        c = hj / denom if denom > 0 else 1.0
        s = hj1 / denom if denom > 0 else 0.0
        hcol[j] = c * hj + s * hj1
        gj = g[j]
        g[j], g[j + 1] = c * gj, -s * gj
        cs[j], sn[j] = c, s
        for i in range(j + 1):
            R[i][j] = hcol[i]
        res = abs(g[j + 1])
        j += 1
    if j == 0:
        return x0, res, 0
    Rk = torch.tensor([row[:j] for row in R[:j]], dtype=torch.float64)
    gk = torch.tensor(g[:j], dtype=torch.float64)[:, None]
    y = torch.linalg.solve_triangular(Rk, gk, upper=True)[:, 0]
    upd = y.to(dtype=V.dtype, device=V.device) @ V[:j]
    return x0 + M(upd), res, j


def gmres(matvec, b, *, m=40, tol=1e-8, atol=0.0, max_restarts=5,
          precond=None, x0=None):
    """Restarted, right-preconditioned GMRES(m) with convergence check.
    Returns (x, KrylovInfo)."""
    M = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    bnorm = host_value(torch.linalg.norm(b))
    target = max(tol * (bnorm if bnorm > 0 else 1.0), atol)
    res = host_value(torch.linalg.norm(b - matvec(x)))
    cyc = steps = 0
    while res > target and cyc < max_restarts:
        with timed("krylov::cycle"):
            r = b - matvec(x)
            x, res, k = _gmres_cycle(matvec, M, x, r, target, m)
        count("krylov::arnoldi_steps", k)
        cyc += 1
        steps += k
    return x, KrylovInfo(steps, res, res <= target)


def gmres_fixed(matvec, b, *, m=40, precond=None, x0=None):
    """GMRES(m), one fixed-length cycle: m Arnoldi steps (classical
    Gram-Schmidt against the whole basis, the rows not yet built being
    zero), then the minimal-norm least-squares solution of the (m+1, m)
    Hessenberg system (the SVD one of jnp.linalg.lstsq). No convergence
    check: use `gmres` for one."""
    M = precond if precond is not None else _identity
    x0 = torch.zeros_like(b) if x0 is None else x0
    r0 = b - matvec(x0)
    beta = torch.linalg.norm(r0)
    V = b.new_zeros((m + 1, b.shape[0]))
    V[0] = r0 / torch.where(beta > 0, beta, 1.0)
    H = b.new_zeros((m + 1, m))
    for j in range(m):
        w = matvec(M(V[j]))
        hcol = V @ w
        w = w - hcol @ V
        hnorm = torch.linalg.norm(w)
        V[j + 1] = w / torch.where(hnorm > 0, hnorm, 1.0)
        hcol[j + 1] = hnorm
        H[:, j] = hcol
    g = b.new_zeros(m + 1)
    g[0] = beta
    y = torch.linalg.pinv(H) @ g
    return x0 + M(y @ V[:m])


def bicgstab_fixed(matvec, b, *, iters=20, precond=None, x0=None):
    """BiCGStab with a fixed iteration count and right preconditioner."""
    M = precond if precond is not None else _identity
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x)
    rhat = r
    eps = 1e-30
    p = torch.zeros_like(b)
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    for _ in range(iters):
        rho1 = torch.dot(rhat, r)
        beta = (rho1 / (rho + eps)) * (alpha / (omega + eps))
        p = r + beta * (p - omega * v)
        ph = M(p)
        v = matvec(ph)
        alpha = rho1 / (torch.dot(rhat, v) + eps)
        s = r - alpha * v
        sh = M(s)
        t = matvec(sh)
        omega = torch.dot(t, s) / (torch.dot(t, t) + eps)
        x = x + alpha * ph + omega * sh
        r = s - omega * t
        rho = rho1
    return x


@timed("krylov::cg")
def pcg(matvec, b, *, tol=1e-5, atol=0.0, maxiter=None, M=None):
    """Preconditioned CG from x0 = 0, stopping when ||r|| <=
    max(tol*||b||, atol) or after maxiter steps (jax.scipy's cg).
    Returns (x, steps)."""
    M = M if M is not None else _identity
    maxiter = 10 * b.shape[0] if maxiter is None else maxiter
    atol2 = max(tol * tol * host_value(torch.dot(b, b)), atol * atol)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    z = M(r)
    p = z
    gamma = torch.dot(r, z)
    k = 0
    while k < maxiter and host_value(torch.dot(r, r)) > atol2:
        Ap = matvec(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    count("krylov::cg_iters", k)
    return x, k


@timed("krylov::cg")
def pcg_reference(matvec, b, diag, *, tol=1e-2, maxiter=100):
    """Diagonal-preconditioned CG with the reference's exact stopping
    rule (SolverManager::PCG: x0 = 0, iterate while ||r|| / ||r0|| > tol
    and iter < maxiter). Used for the fully explicit consistent-mass
    solve, where the reference's LOOSE default tol (1e-2) is part of the
    observable gold output; the iterate sequence is scale-invariant, so
    matching the stopping rule matches the gold."""
    d = torch.where(diag != 0, diag, torch.ones_like(diag))
    x = torch.zeros_like(b)
    r = b
    r0n = host_value(torch.linalg.norm(r))
    target = tol * (r0n if r0n > 0 else 1.0)
    p = torch.zeros_like(b)
    rho = 1.0
    rnorm = r0n
    it = 0
    while it < maxiter and rnorm > target:
        z = r / d
        rho_n = torch.dot(r, z)
        beta = 0.0 if it == 0 else rho_n / rho
        p = z + beta * p
        q = matvec(p)
        alpha = rho_n / torch.dot(p, q)
        x = x + alpha * p
        r = r - alpha * q
        rho = rho_n
        rnorm = host_value(torch.linalg.norm(r))
        it += 1
    count("krylov::cg_iters", it)
    return x
