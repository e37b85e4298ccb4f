"""Time integration: Butcher tableaus x BDF history, adaptive stepping.

The port of the JAX package's `mrhyde_tpu/solvers/time_integration.py`
(reference SolverManager: setButcherTableau, setBackwardDifference,
transientSolver; the seeding formulas of workset.cpp):

  per step:  shift the u_prev history, u_prev[0] = u
    per stage s:
      unknown z = u_stage[s]; initial guess = u at step start
      u_eval = alpha_u z + beta_u,  alpha_u = A(s,s)/b(s),
      beta_u = (1-alpha_u) u_prev0
               + sum_{r<s} A(s,r)/b(r) (u_stage_r - u_prev0)
      u_dot = alpha_t z + beta_t,   alpha_t = BDF(0)/(dt b(s)),
      beta_t = (sum_{k>=1} BDF(k) u_prev_{k-1})/(dt b(s))
      Newton-solve R(u_eval, u_dot, t + c_s dt) = 0 for z
      if multi-stage: u += u_stage[s] - u_prev0
  Newton failure => halve dt, revert, retry (max_cuts).

The step and stage loops run on the host in plain torch; every vector
keeps the device and dtype of the state it is given. A dynamic
discretized parameter carries one field per step ((n_steps, n_dof) in
pvec): step k reads row k. A multiscale model (multiscale/subgrid.py)
steps with the macro stages: its fine history and each stage's seeding
weights ride pvec["__ms"], each accepted stage records the fine stage
solutions, and an accepted step commits them (reference
subgridDtN_solver.cpp:280-330 copies the macro tableau and BDF weights
into the fine workset).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import BlockJacobian, TimeCoeffs
from mrhyde_tpu_torch.solvers.krylov import pcg_reference
from mrhyde_tpu_torch.solvers.nonlinear import newton_solve

__all__ = ["butcher_tableau", "bdf_weights", "TransientIntegrator"]

_NO_COUNTS = {"stages": 0, "newton_iters": 0, "linear_iters": 0}


def butcher_tableau(name: str, custom=None):
    """(A, b, c) numpy arrays. Names follow the reference input deck."""
    s3 = np.sqrt(3.0)
    if name in ("BWE", "DIRK-1,1"):
        return (np.array([[1.0]]), np.array([1.0]), np.array([1.0]))
    if name == "FWE":
        return (np.array([[0.0]]), np.array([1.0]), np.array([0.0]))
    if name == "CN":
        return (np.array([[0.0, 0.0], [0.5, 0.5]]), np.array([0.5, 0.5]),
                np.array([0.0, 1.0]))
    if name == "SSPRK-3,3":
        A = np.zeros((3, 3))
        A[1, 0] = 1.0
        A[2, 0] = 0.25
        A[2, 1] = 0.25
        return (A, np.array([1 / 6, 1 / 6, 2 / 3]),
                np.array([0.0, 1.0, 0.5]))
    if name == "RK-4,4":
        A = np.zeros((4, 4))
        A[1, 0] = 0.5
        A[2, 1] = 0.5
        A[3, 2] = 1.0
        return (A, np.array([1 / 6, 1 / 3, 1 / 3, 1 / 6]),
                np.array([0.0, 0.5, 0.5, 1.0]))
    if name == "DIRK-1,2":
        return (np.array([[0.5]]), np.array([1.0]), np.array([0.5]))
    if name == "DIRK-2,2":
        return (np.array([[0.25, 0.0], [0.5, 0.25]]), np.array([0.5, 0.5]),
                np.array([0.25, 0.75]))
    if name == "DIRK-2,3":
        a = 0.5 + s3 / 6
        return (np.array([[a, 0.0], [-s3 / 3, a]]), np.array([0.5, 0.5]),
                np.array([a, 0.5 - s3 / 6]))
    if name == "DIRK-3,3":
        p = 0.4358665215
        A = np.array([
            [p, 0.0, 0.0],
            [(1 - p) / 2, p, 0.0],
            [-1.5 * p * p + 4 * p - 0.25, 1.5 * p * p - 5 * p + 1.25, p]])
        b = np.array([-1.5 * p * p + 4 * p - 0.25,
                      1.5 * p * p - 5 * p + 1.25, p])
        return (A, b, np.array([p, (1 + p) / 2, 1.0]))
    if name == "leap-frog":
        return (np.array([[0.0, 0.0], [1.0, 0.0]]), np.array([1.0, 1.0]),
                np.array([0.0, 0.0]))
    if name == "custom":
        A, b, c = custom
        return (np.atleast_2d(np.asarray(A, dtype=float)),
                np.asarray(b, dtype=float), np.asarray(c, dtype=float))
    raise ValueError(f"unknown Butcher tableau {name!r}")


def bdf_weights(order: int, transient: bool = True) -> np.ndarray:
    """BDF weights for u_dot (1/dt applied separately)."""
    if not transient:
        return np.array([1.0])
    tables = {
        1: [1.0, -1.0],
        2: [1.5, -2.0, 0.5],
        3: [11 / 6, -3.0, 1.5, -1 / 3],
        4: [25 / 12, -4.0, 3.0, -4 / 3, 0.25],
        5: [137 / 60, -5.0, 5.0, -10 / 3, 75 / 60, -0.2],
        6: [147 / 60, -6.0, 7.5, -20 / 3, 225 / 60, -72 / 60, 1 / 6],
    }
    return np.array(tables[order])


@dataclass
class TransientIntegrator:
    """Drives one physics set through the transient solve."""

    assembler: object
    # the stage solve: newton_solve, or a drop-in with its signature (the
    # sharded Newton of parallel/deck_sharded.py); None: newton_solve
    newton_fn: object = None
    tableau: str = "BWE"
    bdf_order: int = 1
    startup_tableau: str | None = None
    startup_bdf_order: int | None = None
    startup_steps: int = 0
    custom_tableau: tuple | None = None
    nonlinear_tol: float = 1e-6
    abs_tol: float = 1e-100
    max_nonlinear_iters: int = 10
    linear_method: str = "direct"
    linear_tol: float = 1e-12
    precond_variant: str = "jacobi"
    max_cuts: int = 5
    backtracking: bool = True
    pvec: dict | None = None
    set_dirichlet: object = None   # callable (u, time) -> u with DBCs set
    dynamic_params: tuple = ()     # discretized params with a row per step
    fully_explicit: bool = False   # reference: explicitSolver
    lump_mass: bool = True
    mass_cg_iters: int = 100   # reference 'max linear iters' default
    mass_cg_tol: float = 1e-2  # reference explicit 'linear TOL' default
    # stage solves, Newton iterations and Krylov iterations, counted
    # from the start of the last run()
    counts: dict = field(default_factory=lambda: dict(_NO_COUNTS))

    def _tables(self, step: int):
        if (self.startup_steps and step < self.startup_steps
                and self.startup_tableau is not None):
            A, b, c = butcher_tableau(self.startup_tableau,
                                      self.custom_tableau)
            w = bdf_weights(self.startup_bdf_order or 1)
        else:
            A, b, c = butcher_tableau(self.tableau, self.custom_tableau)
            w = bdf_weights(self.bdf_order)
        return A, b, c, w

    def max_history(self):
        w0 = bdf_weights(self.bdf_order)
        w1 = (bdf_weights(self.startup_bdf_order)
              if self.startup_bdf_order else w0)
        return max(len(w0), len(w1)) - 1

    def _explicit_stage(self, z0, tc, pvec=None):
        """Exact explicit-stage update (reference explicitSolver): the
        stage system is affine in z with Jacobian alpha_t * M, so one
        weighted-mass solve finishes: z = z0 - (alpha_t M)^{-1} R(z0),
        via the lumped diagonal or CG."""
        asm = self.assembler
        r = asm.residual(z0, tc, pvec)
        if self.lump_mass:
            mdiag = asm.lumped_mass(z0, tc, pvec)
            du = -r / (mdiag * tc.alpha_t)
        else:
            M = asm.weighted_mass_blocks(z0, tc, pvec)
            Mop = BlockJacobian(vol=M, vol_lids=asm.lids, fixed=asm.fixed,
                                inc=asm.inc)
            # the reference's 'use custom PCG' path: diagonal-
            # preconditioned CG from x0 = 0 whose loose default rel-tol
            # (1e-2) is visible in the golds
            du = -pcg_reference(Mop.apply, r, Mop.diag(),
                                tol=self.mass_cg_tol,
                                maxiter=self.mass_cg_iters) / tc.alpha_t
        return torch.where(asm.fixed, z0, z0 + du)

    def _pvec_at_step(self, step_index):
        """pvec as step `step_index` sees it: a dynamic discretized
        parameter's (n_steps, n_dof) field gives its row (reference
        dynamic_Psol with updateDynamicParams, solverManager.cpp:1276)."""
        pvec = self.pvec
        if pvec and self.dynamic_params:
            pvec = dict(pvec)
            for name in self.dynamic_params:
                v = pvec.get(name)
                if v is not None and getattr(v, "ndim", 1) == 2:
                    pvec[name] = v[min(step_index, v.shape[0] - 1)]
        return pvec

    def step_once(self, u, u_prev, t, dt, step_index):
        """One time step. Returns (u_new, u_prev_new, ok).

        u_prev: (hist, n) BDF history; updated in the return value.
        """
        asm = self.assembler
        step_pvec = self._pvec_at_step(step_index)
        A, b, c, w = self._tables(step_index)
        nstage = len(b)
        # shift history, current solution into slot 0
        u_prev = torch.roll(u_prev, 1, dims=0)
        u_prev[0] = u
        u_step_start = u
        u_stages = []
        ok = True
        u_new = u
        ms = getattr(asm, "multiscale", None)
        if ms is not None and ms.fine_prev is None:
            ms.init_history(self.max_history(), u.dtype, t0=t)
        if ms is not None and hasattr(ms, "update_masks"):
            # dynamic multimodel: ownership re-voted at the step start
            # (reference solverManager.cpp:1316 identifySubgridModels)
            ms.update_masks(t)
        ms_stages = None if ms is None else ms.blank_stages(nstage, u.dtype)
        for s in range(nstage):
            z0 = u_step_start
            alpha_u = float(A[s, s] / b[s])
            beta_u = (1.0 - alpha_u) * u_prev[0]
            for r in range(s):
                beta_u = beta_u + float(A[s, r] / b[r]) * (u_stages[r]
                                                           - u_prev[0])
            timewt = 1.0 / (dt * b[s])
            alpha_t = float(w[0] * timewt)
            beta_t = torch.zeros_like(u)
            for k in range(1, len(w)):
                beta_t = beta_t + float(w[k]) * u_prev[k - 1]
            beta_t = beta_t * float(timewt)
            t_stage = float(t + c[s] * dt)
            tc = TimeCoeffs(alpha_u, beta_u, alpha_t, beta_t, t_stage,
                            float(dt))
            pvec_stage = step_pvec
            if ms is not None:
                pvec_stage = {**(step_pvec or {}), "__ms": ms.stage_ms_entry(
                    ms_stages, s, A, b, w, timewt, u.dtype, t=t, dt=dt,
                    u_prev=u_prev)}
            if self.set_dirichlet is not None:
                z0 = self.set_dirichlet(z0, t_stage)
            self.counts["stages"] += 1
            if self.fully_explicit:
                z = self._explicit_stage(z0, tc, step_pvec)
            else:
                result = (self.newton_fn or newton_solve)(
                    asm, z0, tc, pvec_stage, tol=self.nonlinear_tol,
                    abstol=self.abs_tol,
                    maxiter=self.max_nonlinear_iters,
                    linear_method=self.linear_method,
                    linear_tol=self.linear_tol,
                    precond_variant=self.precond_variant,
                    backtracking=self.backtracking)
                self.counts["newton_iters"] += result.iterations
                self.counts["linear_iters"] += result.linear_iters
                if not result.converged and result.norm > result.norm0:
                    ok = False
                    break
                z = result.u
            u_stages.append(z)
            if ms is not None:
                ms_stages = ms.record_stage(ms_stages, s, z, tc, pvec_stage)
            if nstage > 1:
                u_new = u_new + z - u_prev[0]
            else:
                u_new = z
        if ok and ms is not None:
            ms.commit_step(ms_stages, nstage)
        return u_new, u_prev, ok

    def run(self, u0, *, t0=0.0, t_end=1.0, dt=None, num_steps=None,
            observer=None):
        """Integrate from t0 to t_end. Returns (u, final time).

        observer(u, time, step) is called after the initial condition and
        after every accepted step (the reference's postproc->record).
        """
        if dt is None:
            dt = (t_end - t0) / (num_steps or 1)
        self.counts = dict(_NO_COUNTS)
        u = u0
        hist = self.max_history()
        u_prev = u[None, :].repeat(max(hist, 1), 1)
        t = t0
        if observer is not None:
            observer(u, t, 0)
        step = 0
        cuts = 0
        timetol = (t_end - t0) * 1e-12
        while t < t_end - timetol and cuts <= self.max_cuts:
            u_new, u_prev_new, ok = self.step_once(u, u_prev, t, dt, step)
            if ok:
                u = u_new
                u_prev = u_prev_new
                t += dt
                step += 1
                if observer is not None:
                    observer(u, t, step)
            else:
                dt *= 0.5
                cuts += 1
        return u, t
