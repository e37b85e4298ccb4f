"""Preconditioners for the matrix-free Krylov solvers.

The port of `mrhyde_tpu/solvers/precond.py`. Each builder takes a
BlockJacobian and returns `v -> M(v)`, the RIGHT preconditioner of
solvers/krylov.py:

- jacobi:     diagonal scaling (Ifpack2 RELAXATION analog)
- chebyshev:  fixed-degree Chebyshev smoother on the Jacobi-scaled
              operator, its spectral radius bounded by Gershgorin row
              sums of the element blocks (Ifpack2 CHEBYSHEV analog)
- schwarz:    element-block additive Schwarz: batched dense inverses of
              the per-element Jacobian blocks, combined with
              1/multiplicity weights (Ifpack2 SCHWARZ analog, one
              element per subdomain)
- fieldsplit_simple_precond: the SIMPLE pressure-Schur split of a saddle
              system, for a caller that passes the pressure mask (no
              deck key selects it)

Every quantity a builder derives from J (the diagonal, lambda_max, the
inverted blocks) stays a tensor on J's device, and `M(v)` reads no host
value, so a Krylov iteration does not wait for the host. The multigrid
variants need the assembler (solvers/multigrid.py, solvers/amg.py) and
reach the Krylov solvers as their `precond_fn`.
"""

from __future__ import annotations

import torch

__all__ = ["build_preconditioner", "jacobi_precond", "chebyshev_precond",
           "element_schwarz_precond", "fieldsplit_simple_precond"]


def jacobi_precond(J):
    dinv = 1.0 / J.diag()
    return lambda v: dinv * v


def segment_sum(vals, ids, n):
    """(n,) sums of vals at ids (both flattened; jax.ops.segment_sum)."""
    return vals.new_zeros(n).index_add_(0, ids.reshape(-1), vals.reshape(-1))


def dense_blocks(blocks, lids, n):
    """The (n, n) matrix that sums the element blocks (E, k, k) at their
    dofs lids (E, k): the multigrid hierarchies' coarsest level."""
    k = lids.shape[1]
    A = blocks.new_zeros((n, n))
    return A.index_put_((lids[:, :, None].expand(-1, k, k),
                         lids[:, None, :].expand(-1, k, k)), blocks,
                        accumulate=True)


def _gershgorin_lmax(J, dinv):
    """Safe upper bound on lambda_max(D^-1 A) from the element blocks:
    sum_e |A_e|'s row sums majorize the assembled |A|'s row sums, so
    max_i dinv_i * rowsum_i >= the Gershgorin bound >= lambda_max (a 0-d
    tensor on J's device)."""
    if J.vol is None:                        # row-list fused layout
        nd = J.vol_lids.shape[1]
        E = J.vol_lids.shape[0]
        dt = J._soa_dtype()
        rows_e = []
        for i in range(nd):
            terms = [J.vol_soa[i * nd + j].abs() for j in range(nd)
                     if J.vol_soa[i * nd + j] is not None]
            s = sum(terms) if terms else 0.0
            rows_e.append(torch.broadcast_to(torch.as_tensor(
                s, dtype=dt, device=J.vol_lids.device), (E,)))
        row_e = torch.stack(rows_e, dim=1)
    else:
        row_e = J.vol.abs().sum(dim=2)
    rows = segment_sum(row_e, J.vol_lids, J.n_dof)
    for blocks, lids in zip(J.bnd, J.bnd_lids):
        rows = rows + segment_sum(blocks.abs().sum(dim=2), lids, J.n_dof)
    rows = torch.where(J.fixed, 1.0, rows)
    return torch.max(dinv * rows)


def chebyshev_precond(J, *, degree=4, ratio=30.0, boost=1.05):
    """Chebyshev(k) on the Jacobi-scaled operator D^-1 A: lambda_max
    bounded by `_gershgorin_lmax` (once per Jacobian), lambda_min =
    lambda_max / ratio. Indefinite systems should use schwarz."""
    dinv = 1.0 / J.diag()
    lmax = _gershgorin_lmax(J, dinv) * boost
    lmin = lmax / ratio
    theta = 0.5 * (lmax + lmin)
    delta = 0.5 * (lmax - lmin)
    sigma1 = theta / delta

    def apply(r):
        # Chebyshev iteration for z ~= (D^-1 A)^-1 (D^-1 r) (Saad,
        # Iterative Methods, Alg. 12.1, on the Jacobi-scaled operator)
        x = torch.zeros_like(r)
        res = dinv * r
        rho = 1.0 / sigma1
        d = res / theta
        for _ in range(max(degree - 1, 0)):
            x = x + d
            res = res - dinv * J.apply(d)
            rho_new = 1.0 / (2.0 * sigma1 - rho)
            d = rho_new * rho * d + (2.0 * rho_new / delta) * res
            rho = rho_new
        return x + d

    return apply


def element_schwarz_precond(J, damping=1.0):
    """Element-block weighted additive Schwarz.

    M v = sum_e W R_e^T (A_e + shift)^-1 R_e v, where A_e is the
    element's local Jacobian block (Dirichlet rows/cols replaced by
    identity, its diagonal by the ASSEMBLED diagonal where that is
    nonzero: raw element blocks of elliptic operators are singular) and
    W = diag(damping/multiplicity). A block that stays singular falls
    back to the inverse of its diagonal (torch.linalg.inv_ex reports it,
    where jnp.linalg.inv returns non-finite values)."""
    lids = J.vol_lids                               # (E, nd)
    fixed_e = J.fixed[lids]                         # (E, nd) bool
    vol = J.aos()
    eye = torch.eye(vol.shape[1], dtype=vol.dtype, device=vol.device)
    mask = (~fixed_e[:, :, None]) & (~fixed_e[:, None, :])
    blocks = torch.where(mask, vol, 0.0)
    blocks = blocks + eye * fixed_e[:, :, None]
    d_elem = torch.diagonal(blocks, dim1=1, dim2=2)  # (E, nd)
    d_asm = J.diag()[lids]                           # (E, nd)
    use = (~fixed_e) & (d_asm != 0)
    blocks = blocks + eye * torch.where(use, d_asm - d_elem,
                                        0.0)[:, :, None]
    inv, info = torch.linalg.inv_ex(blocks)
    ok = (info == 0) & torch.isfinite(inv).all(dim=2).all(dim=1)
    dd = torch.diagonal(blocks, dim1=1, dim2=2)
    dinv_blk = eye * (1.0 / torch.where(dd == 0, 1.0, dd))[:, :, None]
    inv = torch.where(ok[:, None, None], inv, dinv_blk)
    mult = segment_sum(torch.ones(lids.shape, dtype=vol.dtype,
                                   device=vol.device), lids, J.n_dof)
    w = damping / torch.where(mult == 0, 1.0, mult)

    def apply(v):
        ze = torch.einsum("eij,ej->ei", inv, v[lids])
        return w * segment_sum(ze, lids, J.n_dof)

    return apply


def fieldsplit_simple_precond(J, p_mask, *, k_A=3, k_S=3, omega=0.7,
                              apply_fn=None):
    """SIMPLE-style pressure-Schur fieldsplit for saddle systems
    (equal-order NS with PSPG), p_mask marking the pressure dofs. All
    sub-solves are fixed-iteration damped Jacobi (linear, so plain right
    preconditioned GMRES stays valid):

      u_hat = A^{-1}~ r_u                 (k_A sweeps on the velocity
                                           block)
      p     = S_hat^{-1}~ (r_p - C u_hat) (k_S sweeps; S_hat v =
                                           S v - C dinvA B v)
      u     = u_hat - dinvA B p

    ~(k_A + 2 k_S + 1) operator applies per application."""
    Jap = apply_fn if apply_fn is not None else J.apply
    dinv = 1.0 / J.diag()
    dinvA = torch.where(p_mask, 0.0, dinv)
    dinvS = torch.where(p_mask, dinv, 0.0)

    def mask_u(v):
        return torch.where(p_mask, 0.0, v)

    def mask_p(v):
        return torch.where(p_mask, v, 0.0)

    def A_apply(v):            # velocity block: u rows of J on u dofs
        return mask_u(Jap(mask_u(v)))

    def A_solve(r_u):
        x = omega * dinvA * r_u
        for _ in range(k_A - 1):
            x = x + omega * dinvA * (r_u - A_apply(x))
        return x

    def S_apply(yp):           # SIMPLE Schur: S y - C dinvA B y
        Jy = Jap(mask_p(yp))
        return mask_p(Jy) - mask_p(Jap(dinvA * mask_u(Jy)))

    def S_solve(r_p):
        y = omega * dinvS * r_p
        for _ in range(k_S - 1):
            y = y + omega * dinvS * (r_p - S_apply(y))
        return y

    def apply(r):
        r_u, r_p = mask_u(r), mask_p(r)
        u_hat = A_solve(r_u)
        p = S_solve(r_p - mask_p(Jap(u_hat)))
        u = u_hat - dinvA * mask_u(Jap(mask_p(p)))
        return u + p

    return apply


def build_preconditioner(J, variant: str = "jacobi", **kw):
    """Deck-facing factory ('preconditioner variant' key). The multigrid
    variants are not among its names: the Newton step passes their
    V-cycle to GMRES and BiCGStab itself, and CG, which builds its
    preconditioner here, raises ValueError for them, as in the JAX
    package."""
    v = (variant or "jacobi").strip().lower()
    if v in ("none", "identity"):
        return lambda x: x
    if v in ("jacobi", "relaxation", "point relaxation"):
        return jacobi_precond(J)
    if v in ("chebyshev",):
        return chebyshev_precond(J, **kw)
    if v in ("schwarz", "block jacobi", "block-jacobi", "ebe"):
        return element_schwarz_precond(J, **kw)
    raise ValueError(f"unknown preconditioner variant {variant!r}")
