"""Compressible Navier-Stokes (Euler plus viscous stress and heat flux).

The port of the JAX package's `mrhyde_tpu/physics/cns.py` (reference
cns.cpp, compiled out of the reference's importer): the conservative
variables of the Euler module on a CG (HGRAD) basis with Newtonian
viscous fluxes,
  tau = mu (grad u + grad u^T - 2/3 div u I)
  momentum flux += -tau;  energy flux += -(tau u) + q,
  q = -(cp mu / Pr) grad T,  T from the nondimensional EOS,
and the CG collapse of the Euler boundary operator on 'Far-field'
sides, F(S).n + A-(S)(S_inf - S), and 'Slip' sides, the pressure p0 n
on the momentum equations. No fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.ops.sparse_dual import abs_
from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.euler import Euler, eig, flux_n
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["CNS"]


@register("cns")
class CNS(Euler):
    name = "cns"
    # the viscous dissipation stabilizes the CG form: no Peraire
    # interface stabilization or trace variables
    requires_stab = False

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.mu = float(self.settings.get("mu", 1e-3))
        self.Pr = float(self.settings.get("PrNum", 0.7))

    def variables(self):
        return [(v, "HGRAD", 1) for v in self._names()]

    def augment_initial_conditions(self, ics):
        pass                                # no trace variables

    # CG: no interface fluxes; the base no-op keeps cns out of the
    # assembler's face modules
    face_residual = PhysicsModule.face_residual

    def boundary_residual(self, wk):
        """Far-field: F_hat.n = F(S).n + A-(S)(S_inf - S), the HDG trace
        collapsed onto the interior state (reference euler.cpp
        computeBoundaryTerm), S_inf the functions 'Far-field <var>
        <sideset>'; Slip: p0 n on the momentum equations."""
        bct = wk.bcs.get("rho") or wk.bcs.get("rhoux")
        if bct not in ("Far-field", "Slip"):
            return
        dim = self.dim
        g = self.gamma
        names = self._names()
        S = torch.stack([wk.sol(v) for v in names], dim=1)   # (Qf, neq)
        n = wk.normals                                       # (Qf, dim)
        if bct == "Slip":
            rho = S[:, 0]
            mom = S[:, 1:1 + dim]
            p0 = (g - 1.0) * (S[:, 1 + dim]
                              - 0.5 * (mom * mom).sum(dim=1) / rho)
            for d, name in enumerate(self._mom_names()):
                wk.add_source(name, p0 * n[:, d])
            return
        Sinf = torch.stack(
            [wk.qp(wk.f(f"Far-field {v} {wk.side_name}", "side ip"))
             for v in names], dim=1)
        L, lam, R = eig(S, n, g, dim)
        lam_m = 0.5 * (lam - abs_(lam))
        w = lam_m * torch.einsum("qij,qj->qi", L, Sinf - S)
        tot = flux_n(S, n, g) + torch.einsum("qij,qj->qi", R, w)
        for i, v in enumerate(names):
            wk.add_source(v, tot[:, i])

    def volume_residual(self, wk):
        super().volume_residual(wk)         # the inviscid part, sources
        dim = self.dim
        g = self.gamma
        rho = wk.sol("rho")
        rhoE = wk.sol("rhoE")
        mom = [wk.sol(m) for m in self._mom_names()]
        vel = [m / rho for m in mom]
        grho = wk.grad("rho")
        gmom = [wk.grad(m) for m in self._mom_names()]
        # velocity gradients: d(m/rho) = (dm - v drho)/rho
        gvel = [(gmom[d] - vel[d][:, None] * grho) / rho[:, None]
                for d in range(dim)]
        G = torch.stack(gvel, dim=1)                # (Q, d, d)
        divu = torch.diagonal(G, dim1=1, dim2=2).sum(dim=1)
        eye = torch.eye(dim, dtype=G.dtype, device=G.device)
        tau = self.mu * (G + G.transpose(1, 2)
                         - (2.0 / 3.0 * divu)[:, None, None] * eye)
        for d, name in enumerate(self._mom_names()):
            wk.add_flux(name, tau[:, d, :])         # +(tau, grad v)
        # energy: the viscous work and the Fourier heat flux
        u_vec = torch.stack(vel, dim=1)             # (Q, d)
        tau_u = torch.einsum("qij,qj->qi", tau, u_vec)
        ke = 0.5 * sum(m * m for m in mom) / rho
        p0 = (g - 1.0) * (rhoE - ke)
        # T = gamma Ma^2 p0 / rho, by the chain rule with
        # grad KE = sum_j v_j grad m_j - (KE/rho) grad rho
        gKE = (sum(vel[j][:, None] * gmom[j] for j in range(dim))
               - (ke / rho)[:, None] * grho)
        gp0 = (g - 1.0) * (wk.grad("rhoE") - gKE)
        Ma2 = self.Ma ** 2
        gT = g * Ma2 * (gp0 / rho[:, None]
                        - (p0 / rho ** 2)[:, None] * grho)
        kheat = self.cp * self.mu / self.Pr
        wk.add_flux("rhoE", tau_u + kheat * gT)
