"""Differentiable forward model: J(p) and dJ/dp by autograd.

The port of the JAX package's `mrhyde_tpu/analysis/forward_ad.py`, the
counterpart of the reference's forward + adjoint analysis
(analysisManager.cpp forwardSolve / adjointSolve): the initial
condition, every time stage (an implicit-function stage solve,
analysis/adjoint.py) and the objective's accumulation form one torch
expression of the active parameters, and autograd runs the reference's
reverse time sweep with transposed stage solves.

Long transients rematerialize: from 40 steps on (or with the Solver key
'adjoint checkpoint window' > 0) the step loop runs in windows of
ceil(sqrt(n)) steps under torch.utils.checkpoint, so the backward keeps
only the window boundaries' states and recomputes the steps inside (the
JAX package's jax.checkpoint windows).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from mrhyde_tpu_torch.analysis.adjoint import make_stage_solver
from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
from mrhyde_tpu_torch.solvers.time_integration import (bdf_weights,
                                                       butcher_tableau)

__all__ = ["DifferentiableForward"]


class DifferentiableForward:
    """objective(pvec) as one differentiable torch function of the whole
    solve. objective_fn(u, time, pvec) -> the scalar contribution at one
    record time (e.g. ObjectiveManager.value); a transient run sums it
    over the steps."""

    def __init__(self, problem, objective_fn, *, newton_tol=1e-10,
                 newton_maxiter=10):
        self.problem = problem
        self.objective_fn = objective_fn
        sc = problem.solver_cfg
        linear = "auto"
        if sc.get("use direct solver", False):
            linear = "dense"
        elif sc.get("matrix free", False):
            linear = "iterative"
        self.stage_solve = make_stage_solver(
            problem.assembler, tol=newton_tol, maxiter=newton_maxiter,
            linear=linear, linear_method=problem._linear_method(),
            linear_tol=float(sc.get("linear TOL", 1e-12)),
            precond_variant=problem._precond_variant())
        self.mode = sc.get("solver", "steady-state")
        self.t0 = float(sc.get("initial time", 0.0))
        self.t_end = float(sc.get("final time", 1.0))
        nsteps = int(sc.get("number of steps", 1))
        dt = sc.get("delta t")
        self.dt = float(dt) if dt is not None else \
            (self.t_end - self.t0) / nsteps
        self.nsteps = nsteps if dt is None else \
            int(round((self.t_end - self.t0) / self.dt))
        self.tableau = sc.get("transient Butcher tableau", "BWE")
        self.bdf_order = int(sc.get("transient BDF order", 1))
        # the reference's startup defaults (solverManager.cpp:149-152):
        # tableau = main tableau, BDF order = main order, steps = order
        self.startup_tableau = sc.get("transient startup Butcher tableau",
                                      self.tableau)
        self.startup_bdf = sc.get("transient startup BDF order",
                                  self.bdf_order)
        self.startup_steps = int(sc.get("transient startup steps",
                                        self.bdf_order))
        # 0 = automatic (sqrt windows from 40 steps); negative = off
        self.ckpt_window = int(sc.get("adjoint checkpoint window", 0))

    # ------------------------------------------------------------------

    def _tables(self, step):
        if (self.startup_steps and step < self.startup_steps
                and self.startup_tableau is not None):
            A, b, c = butcher_tableau(self.startup_tableau)
            w = bdf_weights(int(self.startup_bdf or 1))
        else:
            A, b, c = butcher_tableau(self.tableau)
            w = bdf_weights(self.bdf_order)
        return A, b, c, w

    def _dirichlet(self, time, like):
        return self.problem.bcs.dirichlet_values(time).to(
            dtype=like.dtype, device=like.device)

    def _pvec(self, pvec, like):
        return {k: torch.as_tensor(v, dtype=like.dtype, device=like.device)
                for k, v in (pvec or {}).items()}

    def window(self):
        """The checkpoint window in steps, or 0 for one graph."""
        W = self.ckpt_window
        if W == 0 and self.nsteps >= 40:
            W = int(np.ceil(np.sqrt(self.nsteps)))
        return W if W > 0 and self.nsteps > W else 0

    def objective(self, pvec) -> torch.Tensor:
        """The total objective as a differentiable function of pvec."""
        p = self.problem
        u0 = p.initial_state(self.t0)
        pvec = self._pvec(pvec, u0)
        n = u0.shape[0]
        if self.mode != "transient":
            tc = TimeCoeffs.steady(n, time=self.t0, dtype=u0.dtype,
                                   device=u0.device)
            u = self.stage_solve(u0, tc, pvec, self._dirichlet(self.t0, u0))
            return self.objective_fn(u, self.t0, pvec)

        dt = self.dt
        hist = max(len(bdf_weights(self.bdf_order)) - 1, 1)
        dyn = tuple(nm for nm in p.param_manager.discretized_names()
                    if p.param_manager.specs[nm].dynamic)
        names = tuple(pvec)

        def pvec_at(step, pv):
            # dynamic discretized params: one row per step (the gradient
            # flows back into that row through the slice)
            out = dict(pv)
            for nm in dyn:
                v = out.get(nm)
                if v is not None and v.dim() == 2:
                    out[nm] = v[min(step, v.shape[0] - 1)]
            return out

        def run_steps(u, total, u_prev, pv, steps):
            for step in steps:
                t = self.t0 + step * dt
                pv_k = pvec_at(step, pv)
                A, b, c, w = self._tables(step)
                nstage = len(b)
                u_prev = [u] + u_prev[:-1]
                u_stages = []
                u_new = u
                for s in range(nstage):
                    alpha_u = float(A[s, s] / b[s])
                    beta_u = (1.0 - alpha_u) * u_prev[0]
                    for r in range(s):
                        beta_u = beta_u + float(A[s, r] / b[r]) * (
                            u_stages[r] - u_prev[0])
                    timewt = 1.0 / (dt * b[s])
                    alpha_t = float(w[0] * timewt)
                    beta_t = torch.zeros_like(u)
                    for k in range(1, len(w)):
                        beta_t = beta_t + float(w[k]) * u_prev[k - 1]
                    beta_t = beta_t * float(timewt)
                    t_stage = float(t + c[s] * dt)
                    tc = TimeCoeffs(alpha_u, beta_u, alpha_t, beta_t,
                                    t_stage, float(dt))
                    z = self.stage_solve(u, tc, pv_k,
                                         self._dirichlet(t_stage, u))
                    u_stages.append(z)
                    u_new = u_new + z - u_prev[0] if nstage > 1 else z
                u = u_new
                # the reference records the step's objective at the time
                # its LAST STAGE left in the workset, t + c_last dt (not
                # t + dt: DIRK-1,2's midpoint shifts the targets by dt/2;
                # the JAX package pins it on ODE/DIRK-1,2-Optimization)
                total = total + self.objective_fn(u, float(t + c[-1] * dt),
                                                  pv_k)
            return u, total, u_prev

        u = u0
        u_prev = [u0] * hist
        total = torch.zeros((), dtype=u0.dtype, device=u0.device)
        W = self.window()
        if not W:
            return run_steps(u, total, u_prev, pvec, range(self.nsteps))[1]
        for k0 in range(0, self.nsteps, W):
            steps = tuple(range(k0, min(k0 + W, self.nsteps)))

            def block(u_, total_, *rest, _steps=steps):
                hp, pv = list(rest[:hist]), dict(zip(names, rest[hist:]))
                u2, t2, hp2 = run_steps(u_, total_, hp, pv, _steps)
                return (u2, t2, *hp2)

            out = checkpoint(block, u, total, *u_prev, *pvec.values(),
                             use_reentrant=False)
            u, total, u_prev = out[0], out[1], list(out[2:])
        return total

    def _leaves(self, pvec):
        like = torch.empty(0, dtype=self.problem.dtype,
                           device=self.problem.device)
        return {k: v.detach().clone().requires_grad_(True)
                for k, v in self._pvec(pvec, like).items()}

    def value_and_gradient(self, pvec):
        """(J, {name: dJ/dp}) by one forward and one reverse sweep."""
        leaves = self._leaves(pvec)
        J = self.objective(leaves)
        grads = torch.autograd.grad(J, list(leaves.values()),
                                    allow_unused=True)
        return J.detach(), {k: (torch.zeros_like(v) if g is None else g)
                            for (k, v), g in zip(leaves.items(), grads)}

    def gradient(self, pvec):
        return self.value_and_gradient(pvec)[1]

    def hvp(self, pvec, vec):
        """The Hessian-vector product d2J/dp2 . vec, reverse over reverse
        through the stage solves (the reference's ROL hessVec hook): the
        gradient is built with a graph, whose stage backwards are then
        differentiated again."""
        leaves = self._leaves(pvec)
        J = self.objective(leaves)
        grads = torch.autograd.grad(J, list(leaves.values()),
                                    create_graph=True, allow_unused=True)
        gdot = sum(torch.sum(g * torch.as_tensor(vec[k], dtype=g.dtype,
                                                 device=g.device))
                   for (k, _v), g in zip(leaves.items(), grads)
                   if g is not None and k in vec)
        hv = torch.autograd.grad(gdot, list(leaves.values()),
                                 allow_unused=True)
        return {k: (torch.zeros_like(v) if h is None else h.detach())
                for (k, v), h in zip(leaves.items(), hv)}

    def fd_hvp(self, pvec, vec, eps=1e-5):
        """Central difference of the gradient along vec (ROL's
        checkHessVec)."""
        pp = {k: torch.as_tensor(v) + eps * torch.as_tensor(vec[k])
              for k, v in pvec.items()}
        pm = {k: torch.as_tensor(v) - eps * torch.as_tensor(vec[k])
              for k, v in pvec.items()}
        gp, gm = self.gradient(pp), self.gradient(pm)
        return {k: ((gp[k] - gm[k]) / (2 * eps)).cpu().numpy()
                for k in pvec}

    def fd_gradient(self, pvec, eps=1e-6):
        """Central finite-difference gradient (ROL's checkGradient) for
        verification."""
        out = {}
        for name in pvec:
            base = np.atleast_1d(np.asarray(
                torch.as_tensor(pvec[name]).detach().cpu(), dtype=float))
            g = np.zeros_like(base)
            for i in range(base.size):
                for sgn in (+1, -1):
                    pp = dict(pvec)
                    pert = base.copy()
                    pert[i] += sgn * eps
                    pp[name] = torch.as_tensor(
                        pert.reshape(np.shape(pvec[name]))
                        if base.size > 1 else pert[0])
                    with torch.no_grad():
                        g[i] += sgn * float(self.objective(pp))
            g /= (2 * eps)
            out[name] = g if base.size > 1 else g[0]
        return out
