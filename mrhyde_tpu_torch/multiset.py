"""Multi-set physics: several physics sets on one mesh, solved in turn
with a time integrator per set.

The port of the JAX package's `mrhyde_tpu/multiset.py` (reference
'physics set names' decks, e.g. regression/Multiphysics/
MultiSet_different_timescheme; updatePhysicsSet in the transient loop,
solverManager.cpp:1281; one DOF manager per set,
discretizationInterface.cpp:2324). Each set sees the other sets'
current solutions at its quadrature points as '__field:<var>' (E, Q)
entries of pvec (the reference's multi-set workset gather); the sets'
assemblers name those leaves (`Assembler.set_field_leaves`), so a set
that qualifies still runs its fused kernels, reading them as
coefficients that vary by element.
"""

from __future__ import annotations

from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
from mrhyde_tpu_torch.problem import ForwardResult, Problem
from mrhyde_tpu_torch.solvers.nonlinear import newton_solve
from mrhyde_tpu_torch.solvers.time_integration import TransientIntegrator

__all__ = ["MultiSetProblem"]


def _merge(base: dict, override: dict | None) -> dict:
    out = dict(base or {})
    out.update(override or {})
    return out


class MultiSetProblem:
    def __init__(self, cfg: dict, device=None, dtype=None):
        self.cfg = cfg
        phys = cfg.get("Physics", {}) or {}
        names = [n.strip() for n in
                 str(phys.get("physics set names", "")).split(",")
                 if n.strip()]
        self.set_names = names
        disc_cfg = cfg.get("Discretization", {}) or {}
        solver_cfg = cfg.get("Solver", {}) or {}
        shared_solver = {k: v for k, v in solver_cfg.items()
                         if k not in names}
        self.sets: list[Problem] = []
        mesh = None
        for name in names:
            sub = {
                "Mesh": cfg.get("Mesh", {}),
                "Functions": cfg.get("Functions", {}),
                "Physics": phys.get(name, {}),
                "Discretization": disc_cfg.get(name, disc_cfg),
                "Solver": _merge(shared_solver, solver_cfg.get(name)),
                "Analysis": cfg.get("Analysis", {}),
                "Parameters": cfg.get("Parameters", {}),
                "Postprocess": cfg.get("Postprocess", {}),
                "_deck_dir": cfg.get("_deck_dir", "."),
            }
            p = Problem(sub, device=device, dtype=dtype, mesh=mesh)
            mesh = p.mesh
            self.sets.append(p)
        self.mesh = mesh
        self.device, self.dtype = self.sets[0].device, self.sets[0].dtype
        for i, p in enumerate(self.sets):
            p.assembler.set_field_leaves(
                v for j, q in enumerate(self.sets) if j != i
                for v in q.disc.var_names)
        self.compute_errors = any(p.compute_errors for p in self.sets)

    @property
    def n_dof(self):
        return sum(p.n_dof for p in self.sets)

    # ------------------------------------------------------------------

    def _cross_fields(self, skip: int, states: list):
        """The solutions of every other set as '__field:var' -> (E, Q)."""
        out = {}
        for i, (p, u) in enumerate(zip(self.sets, states)):
            if i == skip:
                continue
            u_e = u[p.assembler.lids]
            for var in p.disc.var_names:
                st, nd = p.disc.offsets[var]
                out[f"__field:{var}"] = u_e[:, st:st + nd] @ \
                    p.assembler.g_bv[p.disc.basis_keys[var]]
        return out

    def run(self) -> ForwardResult:
        mode = (self.cfg.get("Solver", {}) or {}).get("solver",
                                                      "steady-state")
        states = [p.initial_state() for p in self.sets]
        out = ForwardResult(u=states, time=0.0)

        def record(time):
            if not self.compute_errors:
                return
            errs = {}
            for p, u in zip(self.sets, states):
                errs.update(p.error_calc.compute(u, time))
            out.error_history.append((time, errs))

        if mode != "transient":
            # Picard sweeps over the sets, each seeing the others' latest
            # solutions as frozen fields (the reference's 'max subcycles'
            # iterative coupling)
            subcycles = int((self.cfg.get("Solver", {}) or {}).get(
                "max subcycles", 1))
            for _cycle in range(max(subcycles, 1)):
                for i, p in enumerate(self.sets):
                    tc = TimeCoeffs.steady(p.n_dof, dtype=p.dtype,
                                           device=p.device)
                    res = newton_solve(
                        p.assembler, states[i], tc,
                        self._cross_fields(i, states),
                        maxiter=int(p.solver_cfg.get(
                            "max nonlinear iters", 10)),
                        linear_method=p._linear_method())
                    states[i] = res.u
            record(0.0)
            out.u, out.time = states, 0.0
            return out

        # transient: each set keeps its own integrator and history, and
        # the step loop advances the sets in turn (solverManager.cpp:1281)
        integs = []
        for p in self.sets:
            sc = p.solver_cfg
            integs.append(TransientIntegrator(
                assembler=p.assembler,
                tableau=sc.get("transient Butcher tableau", "BWE"),
                bdf_order=int(sc.get("transient BDF order", 1)),
                startup_tableau=sc.get("transient startup Butcher tableau"),
                startup_bdf_order=(int(sc["transient startup BDF order"])
                                   if "transient startup BDF order" in sc
                                   else None),
                startup_steps=int(sc.get("transient startup steps", 0)),
                nonlinear_tol=float(sc.get("nonlinear TOL", 1e-6)),
                max_nonlinear_iters=int(sc.get("max nonlinear iters", 10)),
                linear_method=p._linear_method(),
                set_dirichlet=p.bcs.apply))

        sc0 = self.cfg.get("Solver", {}) or {}
        t0 = float(sc0.get("initial time", 0.0))
        t_end = float(sc0.get("final time", 1.0))
        nsteps = int(sc0.get("number of steps", 1))
        dt = float(sc0.get("delta t", (t_end - t0) / nsteps))
        nsteps = int(round((t_end - t0) / dt))

        record(t0)
        hists = [states[i][None, :].repeat(max(integs[i].max_history(), 1),
                                           1)
                 for i in range(len(self.sets))]
        t = t0
        for step in range(nsteps):
            for i in range(len(self.sets)):
                integ = integs[i]
                integ.pvec = self._cross_fields(i, states)
                u, hist, ok = integ.step_once(states[i], hists[i], t, dt,
                                              step)
                if not ok:
                    raise RuntimeError(
                        f"set {self.set_names[i]} failed at step {step}")
                states[i] = u
                hists[i] = hist
            t += dt
            record(t)
        out.u, out.time = states, t
        out.counts = {k: sum(ig.counts[k] for ig in integs)
                      for k in integs[0].counts}
        return out

