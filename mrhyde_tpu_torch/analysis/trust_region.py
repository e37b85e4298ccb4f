"""ROL-compatible trust-region optimizer: truncated-CG subproblem with
a limited-memory BFGS HESSIAN approximation (secant "Use as Hessian"),
reproducing the reference's optimizer trajectories to print precision.

A copy of the JAX package's numpy-only `mrhyde_tpu/analysis/
trust_region.py`: the port prints the same tables, character for
character.

The reference drives optimization through ROL::Algorithm +
ROL::TrustRegionStep (reference: src/managers/analysisManager.cpp:
559-607 ROLSolve; settings layout e.g. regression/cdr/
2D_source_inversion/input_rol2.yaml "Step: Trust Region"). ROL itself
is an external Trilinos package, so the algorithm here is reconstructed
from its documented behavior and pinned against the printed
trust-region tables in the regression golds (mrhyde.gold):

- model Hessian B: L-BFGS built from accepted (s, y) pairs, B0 =
  (1/gamma) I with gamma = s.y/y.y of the newest pair (Barzilai-Borwein
  type 1); pairs with non-positive curvature are skipped, which is why
  several gold rows show snorm == gnorm (B reset to the identity).
- subproblem: truncated CG with tol = min(abs, rel*gnorm); flagCG 0 =
  converged, 2 = negative curvature, 3 = trust-region boundary,
  1 = iteration limit.
- acceptance ratio rho = ared/pred; tr_flag prints 0 on success and 2
  when the trial increased the objective with positive predicted
  decrease (the only rejection mode the golds exhibit).
- radius: grow gamma2*delta when rho >= eta2; shrink
  gamma1*min(snorm, delta) on weak/failed steps; on a NEGATIVE rho the
  shrink interpolates a quadratic through (f, g.s, ftrial) and takes
  min(gamma1*min(snorm, delta), max(gamma0, theta)*delta)
  (pinned by cdr/2D_source_inversion iter 5: delta = 1.136253e-01).

Table format matches ROL's printedOutput (std::setw fields), so deck
logs diff cleanly against the reference golds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["trust_region_solve", "TRResult", "TRSettings"]

_EPS = np.finfo(float).eps


@dataclass
class TRSettings:
    maxiter: int = 100
    gtol: float = 1e-6
    stol: float = 1e-12
    delta0: float = 10.0
    delta_max: float = 5.0e3
    eta0: float = 0.05          # Step Acceptance Threshold
    eta1: float = 0.05          # Radius Shrinking Threshold
    eta2: float = 0.9           # Radius Growing Threshold
    gamma0: float = 0.0625      # Radius Shrinking Rate (Negative rho)
    gamma1: float = 0.25        # Radius Shrinking Rate (Positive rho)
    gamma2: float = 2.5         # Radius Growing Rate
    secant_memory: int = 10
    cg_maxiter: int = 20
    cg_abstol: float = 1e-4
    cg_reltol: float = 1e-2

    @staticmethod
    def from_rol(rol_cfg: dict) -> "TRSettings":
        """Build from the reference deck's nested ROL sublist
        (General/Secant, General/Krylov, Step/Trust Region,
        Status Test)."""
        gen = rol_cfg.get("General", {}) or {}
        sec = gen.get("Secant", {}) or {}
        kry = gen.get("Krylov", {}) or {}
        tr = (rol_cfg.get("Step", {}) or {}).get("Trust Region", {}) or {}
        st = rol_cfg.get("Status Test", {}) or {}
        g = lambda d, k, dflt: float(d.get(k, dflt))
        return TRSettings(
            maxiter=int(st.get("Iteration Limit", 100)),
            gtol=g(st, "Gradient Tolerance", 1e-6),
            stol=g(st, "Step Tolerance", 1e-12),
            delta0=g(tr, "Initial Radius", 10.0),
            delta_max=g(tr, "Maximum Radius", 5.0e3),
            eta0=g(tr, "Step Acceptance Threshold", 0.05),
            eta1=g(tr, "Radius Shrinking Threshold", 0.05),
            eta2=g(tr, "Radius Growing Threshold", 0.9),
            gamma0=g(tr, "Radius Shrinking Rate (Negative rho)", 0.0625),
            gamma1=g(tr, "Radius Shrinking Rate (Positive rho)", 0.25),
            gamma2=g(tr, "Radius Growing Rate", 2.5),
            secant_memory=int(sec.get("Maximum Storage", 10)),
            cg_maxiter=int(kry.get("Iteration Limit", 20)),
            cg_abstol=g(kry, "Absolute Tolerance", 1e-4),
            cg_reltol=g(kry, "Relative Tolerance", 1e-2),
        )


@dataclass
class TRResult:
    x: np.ndarray
    value: float
    iterations: int
    converged: bool
    status: str = "Iteration Limit Exceeded"
    history: list = field(default_factory=list)


class LBFGSHessian:
    """L-BFGS approximation of the HESSIAN (ROL secant 'Use as
    Hessian'): B = B0 + sum_i (b_i b_i' - a_i a_i'), B0 = (1/gamma) I,
    gamma = s.y/y.y of the newest stored pair."""

    def __init__(self, memory=10):
        self.memory = memory
        self.S, self.Y = [], []
        self._ab = None

    def update(self, s, y):
        sy = float(s @ y)
        if sy <= _EPS * float(np.linalg.norm(s)) \
                * float(np.linalg.norm(y)):
            return False      # curvature condition failed: skip pair
        self.S.append(np.asarray(s, dtype=float).copy())
        self.Y.append(np.asarray(y, dtype=float).copy())
        if len(self.S) > self.memory:
            self.S.pop(0)
            self.Y.pop(0)
        self._ab = None
        return True

    def _factors(self):
        if self._ab is None:
            gamma = float(self.S[-1] @ self.Y[-1]) \
                / float(self.Y[-1] @ self.Y[-1])
            a_list, b_list = [], []
            for s, y in zip(self.S, self.Y):
                b = y / np.sqrt(float(y @ s))
                t = s / gamma
                for aj, bj in zip(a_list, b_list):
                    t = t + float(bj @ s) * bj - float(aj @ s) * aj
                a = t / np.sqrt(float(s @ t))
                a_list.append(a)
                b_list.append(b)
            self._ab = (gamma, a_list, b_list)
        return self._ab

    def apply(self, v):
        v = np.asarray(v, dtype=float)
        if not self.S:
            return v.copy()
        gamma, a_list, b_list = self._factors()
        out = v / gamma
        for a, b in zip(a_list, b_list):
            out = out + float(b @ v) * b - float(a @ v) * a
        return out


def truncated_cg(g, delta, apply_B, maxiter, abstol, reltol):
    """ROL-style truncated CG on  min g.s + 0.5 s.B.s, ||s|| <= delta.

    Returns (s, snorm, pred, iterCG, flagCG); flagCG: 0 converged,
    1 iteration limit, 2 negative curvature, 3 hit boundary."""
    g = np.asarray(g, dtype=float)
    s = np.zeros_like(g)
    gnorm = float(np.linalg.norm(g))
    gtol = min(abstol, reltol * gnorm)
    r = g.copy()
    p = -r
    rho = float(r @ r)
    flag = 1
    it = 0

    def to_boundary(s, p):
        ss, sp, pp = float(s @ s), float(s @ p), float(p @ p)
        disc = sp * sp + pp * (delta * delta - ss)
        return (-sp + np.sqrt(max(disc, 0.0))) / pp

    for i in range(maxiter):
        it = i + 1
        Bp = apply_B(p)
        kappa = float(p @ Bp)
        if kappa <= 0.0:
            s = s + to_boundary(s, p) * p
            flag = 2
            break
        alpha = rho / kappa
        s1 = s + alpha * p
        if float(np.linalg.norm(s1)) >= delta:
            s = s + to_boundary(s, p) * p
            flag = 3
            break
        s = s1
        r = r + alpha * Bp
        rho1 = float(r @ r)
        if np.sqrt(rho1) < gtol:
            flag = 0
            break
        p = -r + (rho1 / rho) * p
        rho = rho1
    snorm = float(np.linalg.norm(s))
    pred = -(float(g @ s) + 0.5 * float(s @ apply_B(s)))
    return s, snorm, pred, it, flag


def _fmt_row(it, value, gnorm, snorm=None, delta=None, nfval=None,
             ngrad=None, tr_flag=None, iter_cg=None, flag_cg=None):
    def e(v):
        return f"{v:.6e}".ljust(15)

    def c(v):
        return f"{v:d}".ljust(10)

    row = "  " + f"{it:d}".ljust(6) + e(value) + e(gnorm)
    row += (" " * 15) if snorm is None else e(snorm)
    row += e(delta)
    if nfval is not None:
        row += c(nfval) + c(ngrad) + c(tr_flag) + c(iter_cg) + c(flag_cg)
    return row.rstrip("\n")


def rol_fd_check(value_and_grad, value_only, x0, d, *, n_steps=3,
                 out=print):
    """ROL-format finite-difference gradient check (the reference's
    obj->checkGradient, analysisManager.cpp:530-556): forward
    differences at steps 10^0..10^-(n_steps-1) along direction d.
    Returns the per-step absolute errors."""
    x0 = np.asarray(x0, dtype=float)
    d = np.asarray(d, dtype=float)
    f0, g0 = value_and_grad(x0)
    gd = float(np.asarray(g0) @ d)
    rows = []
    for k in range(n_steps):
        t = 10.0 ** (-k)
        fd = (float(value_only(x0 + t * d)) - float(f0)) / t
        rows.append((t, gd, fd, abs(fd - gd)))

    out("           Step size           grad'*dir"
        "           FD approx           abs error")
    out("           ---------           ---------"
        "           ---------           ---------")
    for (t, gdir, fd, err) in rows:
        out(f"{t:20.11e}{gdir:20.11e}{fd:20.11e}{err:20.11e}")
    return [r[3] for r in rows]


def trust_region_solve(value_and_grad, x0, settings: TRSettings, *,
                       bounds=None, out=print,
                       value_only=None) -> TRResult:
    """Run the ROL-semantics trust-region iteration, printing the
    reference's table. `value_and_grad(x) -> (float, ndarray)`.
    `value_only(x) -> float` is used for trial evaluations when
    provided (a rejected step costs no gradient, matching ROL's #grad
    counter — and no adjoint solve here). With `bounds`, steps are
    projected onto the box (the reference's Kelley-Sachs model; see
    kelley_sachs_solve for the full counter-exact variant)."""
    cfg = settings
    lo, hi = bounds if bounds is not None else (None, None)
    bounded = lo is not None

    def proj(z):
        return z if lo is None else np.clip(z, lo, hi)

    def criticality(x, g):
        """Bounded criticality measure ||x - P(x - g)|| — what the
        reference prints as gnorm under bounds (ROL TrustRegionStep
        with 'Projected Gradient Criticality Measure' false)."""
        return float(np.linalg.norm(x - proj(x - g))) if bounded \
            else float(np.linalg.norm(g))

    feval = value_only if value_only is not None else \
        (lambda z: value_and_grad(z)[0])

    x = proj(np.asarray(x0, dtype=float).copy())
    f, g = value_and_grad(x)
    f = float(f)
    g = np.asarray(g, dtype=float)
    gnorm = criticality(x, g)
    nfval, ngrad = 1, 1
    delta = cfg.delta0 if cfg.delta0 > 0 else \
        min(max(gnorm, 1e-2), cfg.delta_max)

    out("")
    out("Truncated CG Trust-Region Solver with Limited-Memory BFGS "
        "Hessian Approximation")
    if bounded:
        out("Trust-Region Model: Kelley-Sachs")
    out("  iter  value          gnorm          snorm          delta   "
        "       #fval     #grad     tr_flag   iterCG    flagCG    ")
    out(_fmt_row(0, f, gnorm, None, delta))

    secant = LBFGSHessian(cfg.secant_memory)
    history = [(f, gnorm)]
    status = "Iteration Limit Exceeded"
    converged = False
    snorm_last = np.inf
    it = 0
    while it < cfg.maxiter:
        if gnorm <= cfg.gtol:
            status, converged = "Converged", True
            break
        if snorm_last <= cfg.stol:
            status, converged = "Step Tolerance Met", True
            break
        it += 1
        if bounded:
            # Kelley-Sachs model: eps-active components are pinned
            # (identity Hessian row, zero model gradient), the CG
            # subproblem runs in the inactive subspace
            eps_act = min(gnorm, 1e-3 ** 0.5)
            active = ((x - lo <= eps_act) & (g > 0)) \
                | ((hi - x <= eps_act) & (g < 0))
            inact = ~active

            def apply_Bhat(v):
                vi = np.where(inact, v, 0.0)
                return np.where(inact, secant.apply(vi), v)

            ghat = np.where(inact, g, 0.0)
        else:
            apply_Bhat = secant.apply
            ghat = g
        s, snorm, pred, iter_cg, flag_cg = truncated_cg(
            ghat, delta, apply_Bhat, cfg.cg_maxiter, cfg.cg_abstol,
            cfg.cg_reltol)
        if bounded:
            s = proj(x + s) - x
            snorm = float(np.linalg.norm(s))
            pred = -(float(ghat @ s) + 0.5 * float(s @ apply_Bhat(s)))
        ftrial = float(feval(x + s))
        nfval += 1
        ared = f - ftrial
        # floating-point safeguard a la ROL (Safeguard Size): treat
        # |reductions| below machine-roundoff of f as ties
        eps_f = 10.0 * _EPS * max(1.0, abs(f))
        if abs(ared) < eps_f and abs(pred) < eps_f:
            rho, tr_flag = 1.0, 0
        elif pred > 0.0 and ared > 0.0:
            rho, tr_flag = ared / pred, 0
        elif pred > 0.0:
            rho, tr_flag = ared / pred, 2
        elif ared > 0.0:
            rho, tr_flag = 1.0 / _EPS, 1
        else:
            rho, tr_flag = ared / pred if pred != 0 else -1.0, 3
        accept = (rho >= cfg.eta0) and (tr_flag in (0, 1))

        if accept:
            x_old, g_old = x, g
            x = proj(x + s)
            f = ftrial
            if bounded:
                # Kelley-Sachs post-smoothing: projected-gradient step
                # from the trial point with Armijo backtracking along
                # the projection arc. Costs one gradient at the trial
                # point plus one f-eval per backtrack — the golds'
                # #fval/#grad increments of +2/+2 per accepted
                # iteration (le/2d_two_disc_inversion) and +4/+2
                # (le/2d_sparse_simul_inversion, two backtracks) pin
                # this structure.
                _, gtrial = value_and_grad(x)
                gtrial = np.asarray(gtrial, dtype=float)
                ngrad += 1
                alpha, mu0 = 1.0, 1e-4
                for _ in range(20):
                    xs = proj(x - alpha * gtrial)
                    fs = float(feval(xs))
                    nfval += 1
                    if fs <= f + mu0 * float(gtrial @ (xs - x)):
                        x, f = xs, fs
                        break
                    alpha *= 0.5
            fnew, gnew = value_and_grad(x)
            f = float(fnew)
            gnew = np.asarray(gnew, dtype=float)
            ngrad += 1
            secant.update(x - x_old, gnew - g_old)
            g = gnew
            gnorm = criticality(x, g)
            if rho >= cfg.eta2:
                delta = min(cfg.gamma2 * delta, cfg.delta_max)
            elif rho < cfg.eta1:
                delta = cfg.gamma1 * min(snorm, delta)
            snorm_last = snorm
        else:
            if rho < 0.0:
                # quadratic-interpolation backtracking of the radius
                gs = float(g @ s)
                model_val = f - pred       # m(s) = f + g.s + 0.5 s.B.s
                denom = (1.0 - cfg.eta2) * (f + gs) \
                    + cfg.eta2 * model_val - ftrial
                theta = (1.0 - cfg.eta2) * gs / denom if denom != 0 \
                    else cfg.gamma1
                delta = min(cfg.gamma1 * min(snorm, delta),
                            max(cfg.gamma0, theta) * delta)
            else:
                delta = cfg.gamma1 * min(snorm, delta)
        out(_fmt_row(it, f, gnorm, snorm, delta, nfval, ngrad, tr_flag,
                     iter_cg, flag_cg))
        history.append((f, gnorm))
    else:
        status = "Iteration Limit Exceeded"
    out(f"Optimization Terminated with Status: {status}")
    return TRResult(x=x, value=f, iterations=it, converged=converged,
                    status=status, history=history)
