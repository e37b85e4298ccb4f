"""Deck-level sharded execution: any forward deck with its Newton solves
run sharded.

The port of the JAX package's `mrhyde_tpu/parallel/deck_sharded.py`,
the driver-facing layer over parallel/dof_sharding.py (the
owned/overlapped Tpetra-map analog). The reference runs every regression
deck under `mpiexec -n 4`, with halo Import/Export around assembly and
solve (linearAlgebraInterface.cpp:145-309, solverManager.cpp:1556,1652);
here `Solver: shards: N` (or the CLI's `--shards N`) routes the deck's
Newton solves through the sharded steps:

- assembly, the Jacobi-preconditioned CG / GMRES and every dot product
  run sharded (psum over the shards, halos through ring shifts);
- the iterate crosses between the global vector and its owned slices
  only at Newton-iteration boundaries, so time integration, Dirichlet
  application, multi-set orchestration and postprocessing are
  untouched;
- discretized field params and per-block physics ride the sharded
  per-element extra channel.

Both classes are drop-ins for solvers.nonlinear.newton_solve with its
host loop and 8-cut backtracking; the linear method maps "cg" to CG and
every other method (direct, GMRES, BiCGStab) to GMRES, at the fixed
iteration counts the deck gives (`max linear iters`, `gmres restart
length` x `linear solver restarts`), which NewtonResult.linear_iters
counts.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.parallel.dof_sharding import DofShardedStep
from mrhyde_tpu_torch.solvers.nonlinear import NewtonResult

__all__ = ["ShardedNewton", "ReplicatedShardedNewton"]


class _ShardedLoop:
    """The newton_solve host loop over a sharded (du, |r|) step and a
    sharded residual norm."""

    def __init__(self, linear_method, cg_iters, gmres_m, gmres_restarts):
        self.linear_method = linear_method
        self.cg_iters = cg_iters
        self.gmres_m = gmres_m
        self.gmres_restarts = gmres_restarts

    def _method(self, linear_method):
        if self.linear_method != "auto":
            return self.linear_method
        # direct / gmres / bicgstab and anything else -> sharded GMRES
        # (no sharded direct solver; GMRES covers nonsymmetric decks)
        return "cg" if linear_method == "cg" else "gmres"

    def _iters(self, method):
        return self.cg_iters if method == "cg" \
            else self.gmres_m * self.gmres_restarts

    def __call__(self, assembler, u0, tc, pvec=None, *, tol=1e-6,
                 abstol=1e-100, maxiter=10, linear_method="direct",
                 linear_tol=1e-12, linear_maxiter=2000,
                 backtracking=True, verbose=0,
                 precond_variant="jacobi"):
        """newton_solve-compatible host loop over the sharded step."""
        method = self._method(linear_method)
        u = u0
        norm0 = None
        it = 0
        lin_iters = 0
        while it < maxiter:
            norm, solve = self._res_and_solver(u, tc, pvec, method)
            if norm0 is None:
                norm0 = norm if norm > 0 else 1.0
            if verbose > 1:
                print(f"  Newton iter {it}: ||r|| = {norm:.6e} "
                      f"({self._label} {method})")
            if norm < max(tol * norm0, abstol):
                return NewtonResult(u, it, norm0, norm, True,
                                    linear_iters=lin_iters)
            du = solve()
            lin_iters += self._iters(method)
            if backtracking:
                alpha = 1.0
                for _cut in range(8):
                    rn = self._res_norm(u + alpha * du, tc, pvec)
                    if rn <= norm or alpha < 1e-3:
                        break
                    alpha *= 0.5
                u = u + alpha * du
            else:
                u = u + du
            it += 1
        norm = self._res_norm(u, tc, pvec)
        return NewtonResult(u, it, norm0, norm, norm < max(tol * norm0,
                                                           abstol),
                            linear_iters=lin_iters)


class ShardedNewton(_ShardedLoop):
    """Drop-in for newton_solve running assembly and the Krylov solve
    DOF-sharded (parallel/dof_sharding.py) over a communicator."""

    _label = "sharded"

    def __init__(self, assembler, comm, *, linear_method="auto",
                 cg_iters=200, gmres_m=60, gmres_restarts=4):
        super().__init__(linear_method, cg_iters, gmres_m, gmres_restarts)
        self.comm = comm
        self.dstep = DofShardedStep(assembler, comm)

    def _sharded(self, u, tc):
        ds = self.dstep
        return (ds.gather_global(u), ds.gather_global(tc.beta_u),
                ds.gather_global(tc.beta_t))

    def _res_and_solver(self, u, tc, pvec, method):
        ds = self.dstep
        r, apply, dinv = ds.res_and_operator(*self._sharded(u, tc), tc,
                                             pvec, u_glob=u)
        norm = float(torch.sqrt(ds.dot(r, r)))

        def solve():
            return ds.scatter_global(ds.solve(
                apply, -r, dinv, method, self.cg_iters, self.gmres_m,
                self.gmres_restarts))
        return norm, solve

    def _res_norm(self, u, tc, pvec):
        ds = self.dstep
        r = ds.residual(*self._sharded(u, tc), tc, pvec, u_glob=u)
        return float(torch.sqrt(ds.dot(r, r)))


class ReplicatedShardedNewton(_ShardedLoop):
    """newton_solve drop-in for decks the DOF-sharded path cannot take
    (multiscale decks on macro meshes too small for the halo ring):
    elements and subgrid fine solves are sharded, the macro DOF vector
    stays replicated (the v1 scheme: macro systems in multiscale decks
    are small, the fine solves dominate, and those are what the reference
    dedicates ranks to, split_mpi_communicators.cpp:31-41)."""

    _label = "element-sharded"

    def __init__(self, assembler, comm, *, linear_method="auto",
                 cg_iters=200, gmres_m=60, gmres_restarts=4):
        from mrhyde_tpu_torch.parallel.sharding import _spmd_assemble_builder
        super().__init__(linear_method, cg_iters, gmres_m, gmres_restarts)
        self.comm = comm
        self._assemble, _arrays = _spmd_assemble_builder(assembler, comm)

    def _res_and_solver(self, u, tc, pvec, method):
        from mrhyde_tpu_torch.parallel.sharding import _vdot
        r, apply, dinv = self._assemble(u, tc, pvec)
        norm = float(torch.linalg.norm(r))

        def solve():
            if method == "cg":
                return DofShardedStep._cg(apply, -r, dinv, _vdot,
                                          self.cg_iters)
            return DofShardedStep._gmres(apply, -r, dinv, _vdot,
                                         self.gmres_m, self.gmres_restarts)
        return norm, solve

    def _res_norm(self, u, tc, pvec):
        return float(torch.linalg.norm(
            self._assemble(u, tc, pvec, want_jac=False)[0]))
