"""Differentiable implicit solves: the adjoint machinery.

The port of the JAX package's `mrhyde_tpu/analysis/adjoint.py`. The
reference writes its adjoints by hand: a reverse time sweep over stored
forward states, transposed Jacobian solves and AD-seeded parameter
sensitivities (solverManager.cpp:1181 adjointModel, :1387-1460;
postprocessManager.cpp:4237 computeSensitivities). Here each stage solve
is a `torch.autograd.Function` with the implicit-function derivative:

  forward:  z solves R~(z; tc, pvec, g) = 0,
            R~ = where(fixed, z - g, R(z, tc, pvec)),
            by Newton on `Assembler.res_and_jac`, so the fused kernels
            run where the deck qualifies;
  backward: lambda = J~^{-T} zbar            (the adjoint solve)
            theta_bar = -(dR/dtheta)^T lambda_free
                        for theta = (beta_u, beta_t, pvec),
            through the general path's `Assembler.residual` (the
            kernels compute no dR/dp), and g_bar = lambda at the
            Dirichlet dofs.

J~ has identity Dirichlet rows and live columns. Composing stage solves
in the time loop gives the transient adjoint (the reference's reverse
sweep) by autograd. The backward is itself differentiable when autograd
asks for a graph (Hessian-vector products): it then builds J~ on the
general path and solves densely.

At or below `dense_cutoff` DOFs both solves are dense, as in the JAX
package. Above it the port solves with the deck's own Krylov method and
preconditioner to its linear tolerance, the transposed system on
`BlockJacobian.transposed()`. Where that solve stops unconverged, the
port solves J~^T densely if the dense system fits in a quarter of the
device's free memory, and past that returns the Krylov result with a
warning that gives its residual; JAX runs a fixed-trip Jacobi GMRES(m)
x restarts without a convergence test and returns what it reached
(ROADMAP, deliberate divergences).
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass, field

import torch

from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
from mrhyde_tpu_torch.runtime import free_bytes

__all__ = ["make_stage_solver", "StageSolver"]


@dataclass
class _Call:
    """The non-tensor part of one stage solve."""
    solver: object
    alpha_u: float
    alpha_t: float
    time: float
    deltat: float
    is_steady: bool
    names: tuple

    def tc(self, beta_u, beta_t):
        return TimeCoeffs(self.alpha_u, beta_u, self.alpha_t, beta_t,
                          self.time, self.deltat, is_steady=self.is_steady)


class _StageSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, call, z0, beta_u, beta_t, g, *pvals):
        pvec = dict(zip(call.names, pvals))
        z = call.solver.newton(z0, call.tc(beta_u, beta_t), pvec, g)
        ctx.call = call
        ctx.save_for_backward(z, beta_u, beta_t, g, *pvals)
        return z

    @staticmethod
    def backward(ctx, zbar):
        call = ctx.call
        solver = call.solver
        asm = solver.assembler
        z, beta_u, beta_t, _g, *pvals = ctx.saved_tensors
        create = torch.is_grad_enabled()
        if create:
            # a graph is asked for (a Hessian-vector product): every
            # step differentiable, J~ from the general path
            pvec = dict(zip(call.names, pvals))
            A = asm.jacobian(z, call.tc(beta_u, beta_t), pvec).dense_rowfix()
            lam = torch.linalg.solve(A.T, zbar)
        else:
            z, beta_u, beta_t = z.detach(), beta_u.detach(), beta_t.detach()
            pvals = [p.detach() for p in pvals]
            lam = solver.adjoint(z, call.tc(beta_u, beta_t),
                                 dict(zip(call.names, pvals)), zbar)
        lam_free = torch.where(asm.fixed, 0.0, lam)

        # the partial derivative of R at this z: torch.func.vjp holds z
        # fixed (a path through z would re-enter this Function), while
        # the outer autograd still sees z, p and lambda when a graph is
        # asked for
        def resid(bu, bt, *ps):
            return asm.residual(z, call.tc(bu, bt), dict(zip(call.names, ps)))
        _r, vjp_fn = torch.func.vjp(resid, beta_u, beta_t, *pvals)
        bu_bar, bt_bar, *p_bars = vjp_fn(-lam_free)
        g_bar = torch.where(asm.fixed, lam, 0.0)
        return (None, None, bu_bar, bt_bar, g_bar, *p_bars)


@dataclass
class StageSolver:
    """stage_solve(z0, tc, pvec, g) -> z with the implicit-function
    derivative (see the module docstring). `counts` adds up the forward
    solves, their Newton iterations, the adjoint solves, their Krylov
    iterations and the unconverged Krylov solves finished densely."""
    assembler: object
    tol: float = 1e-10
    maxiter: int = 10
    linear: str = "auto"            # auto | dense | iterative
    dense_cutoff: int = 4096
    linear_method: str = "gmres"    # the deck's, above the cutoff
    linear_tol: float = 1e-12
    linear_maxiter: int = 2000
    precond_variant: str = "jacobi"
    counts: dict = field(default_factory=lambda: {
        "forward": 0, "newton_iters": 0, "adjoint": 0, "adjoint_iters": 0,
        "adjoint_dense_fallback": 0})

    @property
    def dense(self):
        return self.linear == "dense" or (
            self.linear == "auto" and self.assembler.n_dof <= self.dense_cutoff)

    def _krylov(self, J, b):
        """Solve J x = b with the deck's method and preconditioner
        (multigrid variants through the assembler's hierarchy)."""
        from mrhyde_tpu_torch.solvers.linear import solve_linear_info
        from mrhyde_tpu_torch.solvers.nonlinear import (MG_VARIANTS,
                                                        mg_hierarchy)
        variant, pfn = self.precond_variant, None
        if variant in MG_VARIANTS:
            hier = mg_hierarchy(self.assembler, variant)
            if hier is None:
                variant = "schwarz"
            elif self.linear_method in ("gmres", "bicgstab"):
                pfn = hier.preconditioner(J)
        return solve_linear_info(J, b, method=self.linear_method,
                                 tol=self.linear_tol,
                                 maxiter=self.linear_maxiter,
                                 precond_variant=variant, precond_fn=pfn)

    def newton(self, z0, tc, pvec, g):
        """Full Newton steps from z0 with the Dirichlet values g until
        ||R|| <= tol, at most maxiter steps (the JAX package's scan, which
        freezes z once converged)."""
        asm = self.assembler
        pvec = {k: v.detach() for k, v in pvec.items()}
        z = torch.where(asm.fixed, g, z0)
        self.counts["forward"] += 1
        for _ in range(self.maxiter):
            r, J = asm.res_and_jac(z, tc, pvec)
            if float(torch.linalg.norm(r)) <= self.tol:
                break
            if self.dense:
                du = torch.linalg.solve(J.dense(), -r)
            else:
                du, _info = self._krylov(J, -r)
            z = z + du
            self.counts["newton_iters"] += 1
        return z

    def adjoint(self, z, tc, pvec, zbar):
        """lambda = J~^{-T} zbar at the converged z."""
        asm = self.assembler
        pvec = {k: v.detach() for k, v in pvec.items()}
        with torch.no_grad():
            _r, J = asm.res_and_jac(z, tc, pvec)
            self.counts["adjoint"] += 1
            if self.dense:
                return torch.linalg.solve(J.dense_rowfix().T, zbar)
            # J~^T = [[A_FF^T, 0], [A_FD^T, I]]: the free block on the
            # transposed, symmetrically eliminated operator, then the
            # Dirichlet rows lambda_D = zbar_D - A_FD^T lambda_F
            JT = J.transposed()
            x, info = self._krylov(JT, torch.where(asm.fixed, 0.0, zbar))
            self.counts["adjoint_iters"] += int(info.iters)
            if not info.converged:
                # the dense matrix, its transpose and the LU factors
                n = asm.n_dof
                need = 3 * n * n * zbar.element_size()
                if need <= free_bytes(zbar.device) // 4:
                    self.counts["adjoint_dense_fallback"] += 1
                    return torch.linalg.solve(J.dense_rowfix().T, zbar)
                warnings.warn(
                    f"the adjoint's transposed {self.linear_method} solve "
                    f"did not converge: residual {info.resnorm:.3e} after "
                    f"{info.iters} iterations (linear TOL "
                    f"{self.linear_tol:g}); its dense form ({need:,} "
                    "bytes) does not fit, the Krylov result is used",
                    RuntimeWarning, stacklevel=2)
            x = torch.where(asm.fixed, 0.0, x)
            return torch.where(asm.fixed, zbar - JT._apply_raw(x), x)

    def __call__(self, z0, tc, pvec, g):
        pvec = {k: torch.as_tensor(v, dtype=z0.dtype, device=z0.device)
                for k, v in (pvec or {}).items()}
        call = _Call(self, float(tc.alpha_u), float(tc.alpha_t),
                     float(tc.time), float(tc.deltat), bool(tc.is_steady),
                     tuple(pvec))
        return _StageSolve.apply(call, z0, tc.beta_u, tc.beta_t, g,
                                 *pvec.values())


def make_stage_solver(assembler, *, tol=1e-10, maxiter=10, linear="auto",
                      dense_cutoff=4096, linear_method="gmres",
                      linear_tol=1e-12, linear_maxiter=2000,
                      precond_variant="jacobi"):
    """A StageSolver: stage_solve(z0, tc, pvec, g) -> z.

    g: the Dirichlet values (only the fixed dofs' entries are read).
    pvec: active parameters (0-d or 1-d tensors, discretized fields,
    '__field:' entries), differentiable.
    linear: "auto" (dense up to dense_cutoff DOFs, else the Krylov
    method) | "dense" | "iterative".
    """
    return StageSolver(assembler, tol=tol, maxiter=maxiter, linear=linear,
                       dense_cutoff=dense_cutoff, linear_method=linear_method,
                       linear_tol=linear_tol, linear_maxiter=linear_maxiter,
                       precond_variant=precond_variant)
