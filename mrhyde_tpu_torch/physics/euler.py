"""Compressible Euler equations, hybridized (HDG) conservative form.

The port of the JAX package's `mrhyde_tpu/physics/euler.py` (reference
euler.cpp; Peraire 2011): state variables S = (rho, rhoux[, rhouy,
rhouz], rhoE) on a broken space (HGRAD-DG) coupled through facet trace
variables S_hat (HFACE), with the numerical flux on every interface
    F_hat . n = F(S_hat) . n + Stab(S, S_hat) (S - S_hat)
where Stab is one of the two Peraire stabilization matrices built from
the flux-Jacobian eigendecomposition (euler.cpp
computeStabilizationTerm, :965-1085):
    "Roe-like stabilization":  Stab = R |Lambda| L   at S_hat
    "max EV stabilization":    Stab = lambda_max I   at S_hat
The reference refuses to run without one (euler.cpp:61-65); so does the
port. The volume terms (v, S_t) - (grad v, F(S)) - (v, source), the
per-side numerical fluxes (`face_residual`, into the state equations and
the trace continuity equation sum_{e in f} F_hat . n_e = 0) and the
boundary operators assemble inside one vmapped element residual.

Boundary conditions (euler.cpp computeBoundaryTerm, :1091-1285) replace
the trace-continuity equation on boundary facets:
  Far-field: B = A+(S_hat)(S - S_hat) - A-(S_hat)(S_inf - S_hat)
  Slip:      the trace matches the interior density and energy, with
             zero normal velocity
The cns module (physics/cns.py) reads the settings, the volume terms,
`flux_n` and `eig` as a CG form without trace variables. No fused
kernel: the general path.

Nondimensional thermodynamics (euler.cpp computeThermoProps):
  p0 = (gamma-1)(rhoE - 0.5 |rhou|^2 / rho)
  T  = gamma Ma^2 p0 / rho,   a = sqrt(T)/Ma = sqrt(gamma p0 / rho)
"""

from __future__ import annotations

import math

import torch

from mrhyde_tpu_torch.ops.sparse_dual import abs_
from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Euler", "flux_n", "eig"]


@register("Euler")
class Euler(PhysicsModule):
    name = "euler"
    # subclasses with their own dissipation (cns's viscous fluxes) run
    # as plain CG without the Peraire interface stabilization
    requires_stab = True

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        s = self.settings
        self.gamma = float(s.get("gamma", 1.4))
        self.cp = float(s.get("cp", 1004.5))
        self.RGas = float(s.get("RGas", 287.0))
        self.URef = float(s.get("URef", 3.431143))
        self.TRef = float(s.get("TRef", 293.0))
        # the reference Mach number Ma = URef / sqrt(gamma R TRef)
        self.Ma = self.URef / math.sqrt(self.gamma * self.RGas * self.TRef)
        self.roestab = bool(s.get("Roe-like stabilization", False))
        self.maxEVstab = bool(s.get("max EV stabilization", False))
        if self.requires_stab and not (self.roestab or self.maxEVstab) \
                and not s.get("_allow no stabilization", False):
            # the reference refuses to run without one (euler.cpp:63-65)
            raise ValueError(
                "Euler: no stabilization method chosen! Set "
                "'Roe-like stabilization: true' or "
                "'max EV stabilization: true' in the Physics sublist.")

    def variables(self):
        trace_order = 0 if self.dim == 1 else 1
        return [(v, "HGRAD-DG", 1) for v in self._names()] \
            + [(v + "_hat", "HFACE", trace_order) for v in self._names()]

    def augment_initial_conditions(self, ics: dict):
        """Default each trace IC to its state IC (the facet trace of the
        initial field): a zero trace would make the first Newton
        linearization divide by rho_hat = 0."""
        for v in self._names():
            if v + "_hat" not in ics and v in ics:
                ics[v + "_hat"] = ics[v]

    def define_functions(self, fm, fs):
        for v in ("rho", "rhoux", "rhouy", "rhouz", "rhoE"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")

    def _mom_names(self):
        return ["rhoux", "rhouy", "rhouz"][:self.dim]

    def _names(self):
        return ["rho"] + self._mom_names() + ["rhoE"]

    def volume_residual(self, wk):
        """(v, S_t) - (grad v, F(S)) - (v, source) (euler.cpp
        volumeResidual :151-466)."""
        dim = self.dim
        g = self.gamma
        rho = wk.sol("rho")
        rhoE = wk.sol("rhoE")
        mom = [wk.sol(m) for m in self._mom_names()]
        ke = 0.5 * sum(m * m for m in mom) / rho
        p0 = (g - 1.0) * (rhoE - ke)
        vel = [m / rho for m in mom]

        wk.add_source("rho", wk.sol_dot("rho") - wk.qp(wk.f("source rho")))
        wk.add_flux("rho", -torch.stack(mom, dim=1))
        for d, name in enumerate(self._mom_names()):
            F = torch.stack([mom[d] * vel[j] + (p0 if j == d else 0.0)
                             for j in range(dim)], dim=1)
            wk.add_source(name, wk.sol_dot(name)
                          - wk.qp(wk.f(f"source {name}")))
            wk.add_flux(name, -F)
        FE = torch.stack([(rhoE + p0) * vel[j] for j in range(dim)], dim=1)
        wk.add_source("rhoE", wk.sol_dot("rhoE")
                      - wk.qp(wk.f("source rhoE")))
        wk.add_flux("rhoE", -FE)

    def _fhat(self, S, Sh, n):
        """The stabilized numerical flux (Q, neq) at states S and traces
        Sh (Q, neq) along normals n (Q, dim)."""
        g = self.gamma
        dim = self.dim
        dS = S - Sh
        if self.roestab:
            # exactly the reference's R|Lambda|L: on a face where the
            # flow is tangential (u.n = 0) the entropy and shear
            # eigenvalues vanish and the trace equation is
            # underdetermined along them, a property of the scheme
            L, lam, R = eig(Sh, n, g, dim)
            stab = _matvec(R, abs_(lam) * _matvec(L, dS))
        elif self.maxEVstab:
            _rho, _mom, _rhoE, vel, p0 = _state(Sh, g, dim)
            a = torch.sqrt(g * p0 / Sh[:, 0])
            vn = (vel * n).sum(dim=1)
            stab = torch.maximum(abs_(vn + a), abs_(vn - a))[:, None] * dS
        else:
            stab = 0.0 * dS     # test-only: demonstrates the singularity
        return flux_n(Sh, n, g) + stab

    def face_residual(self, wk):
        """Per-side numerical flux into both the state equations ((F_hat.n,
        v), euler.cpp boundaryResidual's form on every side) and the
        trace continuity equation ((F_hat.n, mu), euler.cpp computeFlux
        'interface' branch: the two elements' contributions sum through
        the shared HFACE dofs)."""
        names = self._names()
        for s in range(wk.n_sides()):
            S = torch.stack([wk.face_sol(v, s) for v in names], dim=1)
            Qf = S.shape[0]
            Sh = torch.stack([torch.broadcast_to(wk.trace(v + "_hat", s),
                                                 (Qf,)) for v in names],
                             dim=1)
            fhat = self._fhat(S, Sh, wk.face_normals[s])   # (Qf, neq)
            for i, v in enumerate(names):
                wk.add_face_source(v, s, fhat[:, i])
                wk.add_trace_source(v + "_hat", s, fhat[:, i])

    def boundary_residual(self, wk):
        """On a Far-field or Slip side the trace equation's interior form
        (already added by face_residual) is replaced by the boundary
        operator B."""
        bct = wk.bcs.get("rho") or wk.bcs.get("rhoux")
        if bct not in ("Far-field", "Slip"):
            return
        dim = self.dim
        g = self.gamma
        names = self._names()
        S = torch.stack([wk.sol(v) for v in names], dim=1)      # (Qf, neq)
        Sh = torch.stack([wk.sol(v + "_hat") for v in names], dim=1)
        n = wk.normals
        interior = self._fhat(S, Sh, n)
        if bct == "Slip":
            rho, rhoh = S[:, 0], Sh[:, 0]
            vn = ((S[:, 1:1 + dim] / rho[:, None]) * n).sum(dim=1)
            bound = torch.stack(
                [rho - rhoh]
                + [(S[:, 1 + d] / rho - vn * n[:, d]) - Sh[:, 1 + d] / rhoh
                   for d in range(dim)]
                + [S[:, 1 + dim] - Sh[:, 1 + dim]], dim=1)
        else:
            Sinf = torch.stack([
                wk.qp(wk.f(f"Far-field {v} {wk.side_name}", "side ip"))
                for v in names], dim=1)
            L, lam, R = eig(Sh, n, g, dim)
            lam_p = 0.5 * (lam + abs_(lam))
            lam_m = 0.5 * (lam - abs_(lam))
            bound = _matvec(R, lam_p * _matvec(L, S - Sh)) \
                - _matvec(R, lam_m * _matvec(L, Sinf - Sh))
        for i, v in enumerate(names):
            wk.add_source(v + "_hat", bound[:, i] - interior[:, i])


def _matvec(A, x):
    """A[q] @ x[q] over a batch of quadrature points."""
    return torch.einsum("qij,qj->qi", A, x)


def _state(U, gamma, dim):
    """(rho, momentum, rhoE, velocity, p0) of the states U (Q, neq)."""
    rho = U[:, 0]
    mom = U[:, 1:1 + dim]
    rhoE = U[:, 1 + dim]
    vel = mom / rho[:, None]
    p0 = (gamma - 1.0) * (rhoE - 0.5 * (mom * mom).sum(dim=1) / rho)
    return rho, mom, rhoE, vel, p0


def flux_n(U, n, gamma):
    """The Euler normal flux F(U).n, (Q, neq), of the states U (Q, neq)
    along the normals n (Q, dim)."""
    dim = n.shape[1]
    rho, mom, rhoE, vel, p0 = _state(U, gamma, dim)
    un = (vel * n).sum(dim=1)
    return torch.cat([(rho * un)[:, None], mom * un[:, None]
                      + p0[:, None] * n, ((rhoE + p0) * un)[:, None]],
                     dim=1)


def eig(U, n, gamma, dim):
    """(L, lambda, R) of dF_n/dU at each of the states U (Q, neq) along n
    (Q, dim): the right eigenvectors as the columns of R (Q, neq, neq),
    L = R^-1, the eigenvalues lambda (Q, neq) = (u.n - a, u.n ..., u.n +
    a)."""
    rho, mom, rhoE, vel, p0 = _state(U, gamma, dim)
    a = torch.sqrt(gamma * p0 / rho)
    un = (vel * n).sum(dim=1)
    H = (rhoE + p0) / rho
    one = torch.ones_like(rho)
    lam = torch.cat([(un - a)[:, None], un[:, None].expand(-1, dim),
                     (un + a)[:, None]], dim=1)

    def col(c0, mid, last):
        return torch.cat([c0[:, None], mid, last[:, None]], dim=1)
    cols = [col(one, vel - a[:, None] * n, H - a * un),
            col(one, vel, 0.5 * (vel * vel).sum(dim=1))]
    if dim == 2:
        t = torch.stack([-n[:, 1], n[:, 0]], dim=1)
        cols.append(col(torch.zeros_like(rho), t, (vel * t).sum(dim=1)))
    elif dim == 3:
        # a tangent pair, smooth away from axis-aligned degeneracies
        e0 = torch.zeros_like(n)
        e0[:, 0] = 1.0
        e1 = torch.zeros_like(n)
        e1[:, 1] = 1.0
        ref = torch.where((torch.abs(n[:, 0]) < 0.9)[:, None], e0, e1)
        t1 = torch.linalg.cross(n, ref, dim=1)
        t1 = t1 / torch.linalg.vector_norm(t1, dim=1)[:, None]
        t2 = torch.linalg.cross(n, t1, dim=1)
        for t in (t1, t2):
            cols.append(col(torch.zeros_like(rho), t,
                            (vel * t).sum(dim=1)))
    cols.append(col(one, vel + a[:, None] * n, H + a * un))
    R = torch.stack(cols, dim=2)
    return torch.linalg.inv(R), lam, R
