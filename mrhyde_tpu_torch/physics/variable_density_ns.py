"""Low-Mach variable-density Navier-Stokes (VDNS).

The port of the JAX package's `mrhyde_tpu/physics/variable_density_ns.py`
(reference variableDensityNS.cpp): variables ux[, uy, uz], pr, T with
the ideal-gas density rho = p0/(R T); p0 and dp0dt are scalar
PARAMETERS (reference :83-136; defaults 1e5 and 0):
  momentum d: (mu (2 du_d/dx_d - 2/3 div u) - pr, dv/dx_d)
              + (mu (du_d/dx_j + du_j/dx_d), dv/dx_j) for j != d
              + (rho (u_d_t + u . grad u_d) - source_d, v)
              [+ SUPG (tau R_mom,d rho u, grad v)]
              [+ GRADDIV (h^2/tau R_mass, dv/dx_d)]
  continuity: (div u - thermDiv, q)            [+ PSPG (tau R_mom, grad q)]
              thermDiv = (1/T)(T_t + u . grad T) - dp0dt/p0
  energy:     (rho (T_t + u . grad T) - (dp0dt + source_T)/cp, w)
              + (lambda/cp grad T, grad w)     [+ SUPG, diffusivity lambda/cp]
  tau = 1/sqrt((C1 diff/h^2)^2 + (C2 rho|u|/h)^2 + (C3 rho/dt)^2),
  C1 = 4, C2 = 2, C3 = 2 if transient else 0 (computeTau).
The GRADDIV mass residual keeps the reference's dux_dx + duy_dx. The
Neumann (traction) data is subtracted on the sides. No fused kernel:
the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["VDNS"]

_VELS = ["ux", "uy", "uz"]


@register("VDNS")
class VDNS(PhysicsModule):
    name = "VDNS"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.use_supg = bool(self.settings.get("useSUPG", False))
        self.use_pspg = bool(self.settings.get("usePSPG", False))
        self.use_graddiv = bool(self.settings.get("useGRADDIV", False))

    def variables(self):
        out = [("ux", "HGRAD", 1), ("pr", "HGRAD", 1), ("T", "HGRAD", 1)]
        if self.dim > 1:
            out.insert(1, ("uy", "HGRAD", 1))
        if self.dim > 2:
            out.insert(2, ("uz", "HGRAD", 1))
        return out

    def define_functions(self, fm, fs):
        for v in ("ux", "pr", "uy", "uz", "T"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")
        for n, d in (("mu", 0.01178), ("cp", 1004.5), ("gamma", 1.4),
                     ("RGas", 287.0), ("PrNum", 1.0)):
            fm.add_function(n, self._f(fs, n, d), "ip")
        # p0 is a parameter, not a function (reference :99-101): a deck
        # without one that keeps this default density fails on the leaf
        fm.add_function("rho", self._f(fs, "rho", "p0/(RGas*T)"), "ip")
        fm.add_function("lambda", self._f(fs, "lambda", "cp*mu/PrNum"),
                        "ip")

    @staticmethod
    def _tau(diff, u2, rho, wk):
        """computeTau (variableDensityNS.cpp): note diff/h^2; |u| taken
        only where it is differentiable."""
        c1, c2 = 4.0, 2.0
        c3 = 2.0 if wk.is_transient else 0.0
        nvel = torch.where(u2 > 1e-12, torch.sqrt(u2), u2)
        h = wk.h
        t2 = ((c1 * diff / (h * h)) ** 2 + (c2 * rho * nvel / h) ** 2
              + (c3 * rho / wk.deltat) ** 2)
        return 1.0 / torch.sqrt(t2)

    def volume_residual(self, wk):
        dim = self.dim
        vels = _VELS[:dim]
        mu = wk.qp(wk.f("mu"))
        rho = wk.qp(wk.f("rho"))
        cp = wk.qp(wk.f("cp"))
        lam = wk.qp(wk.f("lambda"))
        p0 = wk.params.get("p0", 100000.0)
        dp0dt = wk.params.get("dp0dt", 0.0)
        pr = wk.sol("pr")
        T = wk.sol("T")
        T_t = wk.sol_dot("T")
        gradT = wk.grad("T")
        src = {v: wk.qp(wk.f(f"source {v}")) for v in vels}
        src["T"] = wk.qp(wk.f("source T"))
        uvals = {v: wk.sol(v) for v in vels}
        udots = {v: wk.sol_dot(v) for v in vels}
        grads = {v: wk.grad(v) for v in vels}
        divu = sum(grads[v][:, d] for d, v in enumerate(vels))
        conv = {v: sum(uvals[w] * grads[v][:, j]
                       for j, w in enumerate(vels)) for v in vels}
        convT = sum(uvals[w] * gradT[:, j] for j, w in enumerate(vels))
        thermdiv = (T_t + convT) / T - dp0dt / p0

        for d, v in enumerate(vels):
            flux = torch.stack(
                [mu * (grads[v][:, j] + grads[vels[j]][:, d])
                 if j != d else
                 mu * (2.0 * grads[v][:, d] - 2.0 / 3.0 * divu) - pr
                 for j in range(dim)], dim=1)
            wk.add_flux(v, flux)
            wk.add_source(v, rho * (udots[v] + conv[v]) - src[v])

        wk.add_source("pr", divu - thermdiv)

        wk.add_source("T", rho * (T_t + convT) - (dp0dt + src["T"]) / cp)
        wk.add_flux("T", (lam / cp)[:, None] * gradT)

        if self.use_supg or self.use_pspg or self.use_graddiv:
            u2 = sum(uvals[v] ** 2 for v in vels)
            tau = self._tau(mu, u2, rho, wk)
            gradp = wk.grad("pr")
            # the strong momentum residuals
            stab = {v: (rho * (udots[v] + conv[v]) + gradp[:, d] - src[v])
                    for d, v in enumerate(vels)}
        if self.use_supg:
            uvec = torch.stack([uvals[v] for v in vels], dim=1)
            for v in vels:
                wk.add_flux(v, (tau * stab[v])[:, None] * rho[:, None]
                            * uvec)
            # energy SUPG with the diffusivity lambda/cp
            tau_T = self._tau(lam / cp, u2, rho, wk)
            strong_T = rho * (T_t + convT) - (dp0dt + src["T"]) / cp
            wk.add_flux("T", (tau_T * strong_T)[:, None] * rho[:, None]
                        * uvec)
        if self.use_graddiv:
            # the reference's mass residual reads dux_dx + duy_dx
            # (variableDensityNS.cpp's GRADDIV blocks), kept for parity
            tau_m = wk.h * wk.h / tau
            strongm = (grads["ux"][:, 0]
                       + (grads["uy"][:, 0] if dim > 1 else 0.0)
                       - thermdiv)
            for d, v in enumerate(vels):
                cols = [torch.zeros_like(pr)] * dim
                cols[d] = tau_m * strongm
                wk.add_flux(v, torch.stack(cols, dim=1))
        if self.use_pspg:
            wk.add_flux("pr", torch.stack([tau * stab[v] for v in vels],
                                          dim=1))

    def boundary_residual(self, wk):
        """The Neumann (traction) data subtracted from the residual
        (reference variableDensityNS.cpp:972+)."""
        for v in _VELS[:self.dim] + ["T"]:
            if wk.bcs.get(v) == "Neumann":
                g = wk.qp(wk.f(f"Neumann {v} {wk.side_name}", "side ip"))
                wk.add_source(v, -g)
