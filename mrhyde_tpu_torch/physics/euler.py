"""Compressible Euler: the part that the cns module reads.

From the JAX package's `mrhyde_tpu/physics/euler.py` (reference
euler.cpp): the settings and the nondimensional thermodynamics
(`Euler.__init__`), the conservative variables' names, the inviscid
volume terms (v, S_t) - (grad v, F(S)) - (v, source), the normal flux
F(S).n (`flux_n`) and the eigendecomposition of its Jacobian (`eig`),
both over a batch of quadrature points. The `Euler` deck name itself
(HDG: trace variables, interface fluxes, the trace boundary operator)
comes with ROADMAP A11, so the class is not registered here.

Nondimensional thermodynamics (euler.cpp computeThermoProps):
  p0 = (gamma-1)(rhoE - 0.5 |rhou|^2 / rho)
  T  = gamma Ma^2 p0 / rho,   a = sqrt(T)/Ma = sqrt(gamma p0 / rho)
"""

from __future__ import annotations

import math

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule

__all__ = ["Euler", "flux_n", "eig"]


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
