"""The port's linear solvers (dense direct, GMRES + Jacobi, PCG +
Jacobi) against the JAX package's on the same BlockJacobian (the
general-path Jacobian of a 6x5 thermal problem at a seeded state) and a
seeded right-hand side.

Tolerance 1e-10 on the solution: both Krylov solves run to 1e-13
relative residual on a 42-dof system with condition number O(10), so
both solutions are within ~1e-12 of the exact one."""

import jax.numpy as jnp
import pytest
import torch

from mrhyde_tpu.solvers.linear import solve_linear_info as jax_solve
from mrhyde_tpu_torch.interop import state_from_numpy
from mrhyde_tpu_torch.solvers.linear import solve_linear_info
from torch_port_utils import both_problems, max_diff, seeded, \
    steady_coeffs, thermal_cfg

torch.set_num_threads(1)

TOL = 1e-10


def _systems(kappa):
    pj, pt = both_problems(thermal_cfg(6, 5, kappa=kappa))
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=11)
    b = seeded(pj.n_dof, seed=12, scale=1.0)
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    return Jj, Jt, b


@pytest.mark.parametrize("method,kappa", [
    ("direct", "1.0 + e*e"), ("gmres", "1.0 + e*e"), ("gmres", "1.0"),
    ("cg", "1.0 + 0.5*x*y")])
def test_solution_matches_jax(method, kappa):
    Jj, Jt, b = _systems(kappa)
    xj, info_j = jax_solve(Jj, jnp.asarray(b), method=method, tol=1e-13,
                           maxiter=500, precond_variant="jacobi")
    xt, info_t = solve_linear_info(Jt, torch.as_tensor(b), method=method,
                                   tol=1e-13, maxiter=500,
                                   precond_variant="jacobi")
    assert bool(info_j.converged) and info_t.converged
    assert max_diff(xt, xj) < TOL
    # the residual the port reports is the true one
    assert abs(info_t.resnorm - float(torch.linalg.norm(
        torch.as_tensor(b) - Jt.apply(xt)))) < 1e-12


def test_gmres_restarts_and_reports_its_residual():
    """A short restart length forces several cycles; the Givens estimate
    it reports is the true residual of the returned x."""
    from mrhyde_tpu_torch.solvers.krylov import gmres
    from mrhyde_tpu_torch.solvers.precond import jacobi_precond
    _Jj, Jt, b = _systems("1.0 + e*e")
    b = torch.as_tensor(b)
    x, info = gmres(Jt.apply, b, m=5, tol=1e-12, max_restarts=200,
                    precond=jacobi_precond(Jt))
    assert info.converged and info.iters > 5
    true = float(torch.linalg.norm(b - Jt.apply(x)))
    assert true <= 1e-11 * float(torch.linalg.norm(b))
    assert abs(true - info.resnorm) < 1e-12


@pytest.mark.parametrize("method,variant", [
    ("cg", "multigrid"), ("gmres", "ilu"), ("bicgstab", "amg")])
def test_variants_raise_where_jax_raises(method, variant):
    """CG builds its preconditioner by name, and the multigrid variants
    are no name there (the Newton step hands their V-cycle to GMRES and
    BiCGStab): both packages raise ValueError, as for an unknown
    variant, and so does an unknown linear method."""
    Jj, Jt, b = _systems("1.0")
    with pytest.raises(ValueError, match="preconditioner variant"):
        jax_solve(Jj, jnp.asarray(b), method=method,
                  precond_variant=variant)
    with pytest.raises(ValueError, match="preconditioner variant"):
        solve_linear_info(Jt, torch.as_tensor(b), method=method,
                          precond_variant=variant)
    with pytest.raises(ValueError, match="linear solver"):
        solve_linear_info(Jt, torch.as_tensor(b), method="minres")


@pytest.mark.parametrize("solver", [
    {}, {"use direct solver": True, "Belos solver": "CG"},
    {"Belos solver": "Pseudo Block CG", "preconditioner variant": "amg",
     "linear TOL": 1e-8, "max linear iters": 300, "Belos block size": 20},
    {"use preconditioner": False, "state solver settings": {
        "Belos solver": "Block CG", "restart": 25}},
    {"param solver settings": {"Belos solver": "Block CG"}}])
def test_linear_options_match_jax(solver):
    """LinearOptions.from_config reads the Solver sublist (and its
    per-system overrides) as the JAX package does."""
    from mrhyde_tpu.solvers.linear import LinearOptions as JaxOptions
    from mrhyde_tpu_torch.solvers.linear import LinearOptions
    for system in ("state", "param"):
        oj = JaxOptions.from_config(solver, system)
        ot = LinearOptions.from_config(solver, system)
        assert vars(ot) == vars(oj)
