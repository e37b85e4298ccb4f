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


def test_unported_variants_raise():
    _Jj, Jt, b = _systems("1.0")
    with pytest.raises(NotImplementedError):
        solve_linear_info(Jt, torch.as_tensor(b), method="gmres",
                          precond_variant="chebyshev")
    with pytest.raises(NotImplementedError):
        solve_linear_info(Jt, torch.as_tensor(b), method="bicgstab")
