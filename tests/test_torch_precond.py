"""The port's preconditioners and fixed-count Krylov solvers
(mrhyde_tpu_torch/solvers/precond.py, krylov.py) against the JAX
package's, on the same BlockJacobian and a seeded vector, in f64 on the
CPU; and decks that name the reference's CHEBYSHEV / SCHWARZ smoothers
or its BiCGStab / TFQMR solvers, through both packages' Problem.

Tolerances: M(v) and the Gershgorin bound 1e-12 relative (the same
arithmetic in another summation order); a fixed-count Krylov solve
1e-10; a deck's solution 1e-10 relative; GMRES iteration counts equal or
within one."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from mrhyde_tpu.solvers import krylov as jkrylov  # noqa: E402
from mrhyde_tpu.solvers import precond as jprecond  # noqa: E402
from mrhyde_tpu.solvers.linear import \
    solve_linear_info as jax_solve  # noqa: E402
from mrhyde_tpu_torch.solvers import krylov, precond  # noqa: E402
from mrhyde_tpu_torch.solvers.linear import solve_linear_info  # noqa: E402
from chip_smoke import smoother, with_solver  # noqa: E402
from torch_port_utils import (both_problems, channel_cfg,  # noqa: E402
                              rel_diff, same_jacobians, seeded,
                              thermal_cdr_affine_cfg, thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-12

# kappa = 1 + e^2 on 12 x 10 quads; thermal + cdr on 16 x 8 with a
# Neumann flux on e and a Flux condition on c (boundary-group blocks)
DECKS = {
    "thermal": lambda: thermal_cfg(12, 10, kappa="1.0 + e*e"),
    "thermal_cdr_flux": lambda: with_mesh(thermal_cdr_affine_cfg("p1"),
                                          16, 8),
}


def with_mesh(cfg, nx, ny):
    cfg["Mesh"].update({"NX": nx, "NY": ny})
    return cfg


def _vector(n, seed=21):
    return seeded(n, seed=seed, scale=1.0)


def _both(fj, ft, v):
    return np.asarray(fj(jnp.asarray(v))), ft(torch.as_tensor(v))


@pytest.mark.parametrize("layout", ["aos", "soa"])
@pytest.mark.parametrize("deck", list(DECKS))
@pytest.mark.parametrize("variant", ["jacobi", "chebyshev", "schwarz"])
def test_preconditioner_matches_jax(variant, deck, layout):
    _pj, _pt, Jj, Jt = same_jacobians(DECKS[deck](), soa=layout == "soa")
    assert bool(Jt.bnd) == (deck == "thermal_cdr_flux")
    mj, mt = _both(jprecond.build_preconditioner(Jj, variant),
                   precond.build_preconditioner(Jt, variant),
                   _vector(Jt.n_dof))
    assert rel_diff(mt, mj) < TOL


@pytest.mark.parametrize("layout", ["aos", "soa"])
@pytest.mark.parametrize("deck", list(DECKS))
def test_gershgorin_bound_matches_jax(deck, layout):
    """The Chebyshev bound on lambda_max(D^-1 A), boundary blocks and
    SoA rows included, stays a 0-d tensor (no host value in M(v))."""
    _pj, _pt, Jj, Jt = same_jacobians(DECKS[deck](), soa=layout == "soa")
    lj = float(jprecond._gershgorin_lmax(Jj, 1.0 / Jj.diag()))
    lt = precond._gershgorin_lmax(Jt, 1.0 / Jt.diag())
    assert isinstance(lt, torch.Tensor) and lt.dim() == 0
    assert abs(float(lt) - lj) <= TOL * lj
    # a bound: at least the largest eigenvalue of D^-1 A
    A = Jt.dense()
    ev = torch.linalg.eigvals(A / Jt.diag()[:, None]).real.max()
    assert float(ev) <= float(lt) * (1 + 1e-12)


def test_schwarz_falls_back_on_a_singular_block():
    """A dof whose rows and columns are zero in every element: its
    assembled diagonal is 0, so its elements' blocks stay singular.
    JAX's inverse turns them non-finite and both packages take the
    block's diagonal inverse there."""
    import dataclasses
    _pj, _pt, Jj, Jt = same_jacobians(DECKS["thermal"]())
    lids = Jt.vol_lids.numpy()
    free = np.flatnonzero(~Jt.fixed.numpy())
    k = int(free[len(free) // 2])
    vol = Jt.vol.numpy().copy()
    e, i = np.nonzero(lids == k)
    vol[e, i, :] = 0.0
    vol[e, :, i] = 0.0
    Jj = dataclasses.replace(Jj, vol=jnp.asarray(vol))
    Jt = dataclasses.replace(Jt, vol=torch.as_tensor(vol))
    assert float(Jt.diag()[k]) == 0.0
    inv = np.asarray(jnp.linalg.inv(jnp.asarray(vol[e])))
    assert not np.isfinite(inv).all()
    mj, mt = _both(jprecond.element_schwarz_precond(Jj),
                   precond.element_schwarz_precond(Jt), _vector(Jt.n_dof))
    assert bool(torch.isfinite(mt).all())
    assert rel_diff(mt, mj) < TOL


def test_simple_fieldsplit_matches_jax_on_the_channel():
    """SIMPLE on the NS channel's saddle blocks (PSPG+SUPG, 10 x 4),
    the pressure dofs masked, as a caller passes it."""
    pj, pt, Jj, Jt = same_jacobians(channel_cfg(10, 4, supg=True))
    pr = pt.disc.dofmap.all_dofs("pr")
    mask = np.zeros(pt.n_dof, dtype=bool)
    mask[pr] = True
    mj, mt = _both(jprecond.fieldsplit_simple_precond(Jj, jnp.asarray(mask)),
                   precond.fieldsplit_simple_precond(Jt,
                                                     torch.as_tensor(mask)),
                   _vector(pt.n_dof))
    assert rel_diff(mt, mj) < TOL


@pytest.mark.parametrize("variant", ["jacobi", "chebyshev", "schwarz"])
def test_gmres_iterations_match_jax(variant):
    """GMRES(40) to 1e-10 on the same J: the same solution, and the
    same iteration count or one apart."""
    _pj, _pt, Jj, Jt = same_jacobians(DECKS["thermal_cdr_flux"]())
    b = _vector(Jt.n_dof, seed=5)
    xj, ij = jax_solve(Jj, jnp.asarray(b), method="gmres", tol=1e-10,
                       maxiter=2000, precond_variant=variant)
    xt, it = solve_linear_info(Jt, torch.as_tensor(b), method="gmres",
                               tol=1e-10, maxiter=2000,
                               precond_variant=variant)
    assert bool(ij.converged) and it.converged
    assert abs(int(ij.iters) - it.iters) <= 1
    assert rel_diff(xt, xj) < 1e-10


@pytest.mark.parametrize("solver", ["bicgstab", "gmres"])
def test_fixed_count_krylov_matches_jax(solver):
    """bicgstab_fixed (20 iterations) and gmres_fixed (one cycle of 30)
    with Jacobi on the same J and right-hand side."""
    _pj, _pt, Jj, Jt = same_jacobians(DECKS["thermal_cdr_flux"]())
    b = _vector(Jt.n_dof, seed=6)
    if solver == "bicgstab":
        xj = jkrylov.bicgstab_fixed(Jj.apply, jnp.asarray(b), iters=20,
                                    precond=jprecond.jacobi_precond(Jj))
        xt = krylov.bicgstab_fixed(Jt.apply, torch.as_tensor(b), iters=20,
                                   precond=precond.jacobi_precond(Jt))
    else:
        xj = jkrylov.gmres_fixed(Jj.apply, jnp.asarray(b), m=30,
                                 precond=jprecond.jacobi_precond(Jj))
        xt = krylov.gmres_fixed(Jt.apply, torch.as_tensor(b), m=30,
                                precond=precond.jacobi_precond(Jt))
    assert rel_diff(xt, xj) < 1e-10


# decks: (config, linear method, preconditioner variant) through both
# packages' Problem.run()
DECK_KEYS = {
    "chebyshev_gmres": (
        lambda: with_solver(thermal_cfg(16, kappa="1.0 + e*e"),
                            **{"Belos solver": "Block GMRES",
                               "nonlinear TOL": 1e-10},
                            **smoother("CHEBYSHEV")),
        "gmres", "chebyshev"),
    "chebyshev_cg": (
        lambda: with_solver(thermal_cfg(16, kappa="1.0 + e*e"),
                            **{"Belos solver": "CG", "nonlinear TOL": 1e-10},
                            **smoother("CHEBYSHEV")),
        "cg", "chebyshev"),
    "schwarz_channel": (
        lambda: with_solver(channel_cfg(10, 4), **{
            "Belos solver": "Block GMRES", "nonlinear TOL": 1e-10},
            **smoother("SCHWARZ")),
        "gmres", "schwarz"),
    "schwarz_variant": (
        lambda: with_solver(thermal_cdr_affine_cfg("p1"), **{
            "preconditioner variant": "schwarz", "nonlinear TOL": 1e-10}),
        "gmres", "schwarz"),
    "chebyshev_variant": (
        lambda: with_solver(thermal_cfg(16, kappa="1.0 + e*e"), **{
            "preconditioner variant": "chebyshev",
            "nonlinear TOL": 1e-10}),
        "gmres", "chebyshev"),
    "bicgstab": (
        lambda: with_solver(thermal_cdr_affine_cfg("p1"), **{
            "Belos solver": "BiCGStab", "nonlinear TOL": 1e-10}),
        "bicgstab", "jacobi"),
    "tfqmr_schwarz": (
        lambda: with_solver(thermal_cfg(16, kappa="1.0 + e*e"), **{
            "Belos solver": "TFQMR", "nonlinear TOL": 1e-10},
            **smoother("SCHWARZ")),
        "bicgstab", "schwarz"),
}


@pytest.mark.parametrize("name", list(DECK_KEYS))
def test_deck_keys_match_jax(name):
    build, method, variant = DECK_KEYS[name]
    pj, pt = both_problems(build())
    assert pt._linear_method() == pj._linear_method() == method
    assert pt._precond_variant() == pj._precond_variant() == variant
    rj, rt = pj.run(), pt.run()
    assert rt.newton.converged
    assert rel_diff(rt.u, np.asarray(rj.u)) < 1e-10
    errs_j, errs_t = rj.error_history[-1][1], rt.error_history[-1][1]
    for key, val in errs_t.items():
        assert abs(float(val) - float(errs_j[key])) <= 1e-10 * abs(
            float(errs_j[key])) + 1e-15
    if method == "bicgstab":
        # 200 fixed iterations per Newton step
        assert rt.counts["linear_iters"] == 200 * rt.counts["newton_iters"]
