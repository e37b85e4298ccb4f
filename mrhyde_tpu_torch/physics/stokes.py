"""Stokes flow physics module (equal-order with PSPG/LSIC).

The port of the JAX package's `mrhyde_tpu/physics/stokes.py` (reference
src/physics/stokes.cpp:95-290):
  momentum d: (visc grad(u_d) - p e_d, grad v) - (source_d, v)
  continuity: (div u, q) [+ PSPG: tau (grad p + source), grad q
              with tau = alpha*h/(2 visc) in 2D, kept verbatim from
              the reference for parity] [+ LSIC]
Like the JAX module it has no qp density, so it always assembles on the
general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Stokes"]

_VELS = ["ux", "uy", "uz"]


@register("Stokes")
@register("stokes")
class Stokes(PhysicsModule):
    name = "stokes"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.use_pspg = bool(self.settings.get("usePSPG", False))
        self.use_lsic = bool(self.settings.get("useLSIC", False))

    def variables(self):
        out = [("ux", "HGRAD", 1), ("pr", "HGRAD", 1)]
        if self.dim > 1:
            out.insert(1, ("uy", "HGRAD", 1))
        if self.dim > 2:
            out.insert(2, ("uz", "HGRAD", 1))
        return out

    def define_functions(self, fm, fs):
        for v in ("ux", "pr", "uy", "uz"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")
        fm.add_function("viscosity", self._f(fs, "viscosity", 1.0), "ip")

    def volume_residual(self, wk):
        dim = self.dim
        visc = wk.qp(wk.f("viscosity"))
        vels = _VELS[:dim]
        sources = {v: wk.qp(wk.f(f"source {v}")) for v in vels}
        pr = wk.sol("pr")
        grads = {v: wk.grad(v) for v in vels}

        for d, v in enumerate(vels):
            cols = [visc * grads[v][:, k] for k in range(dim)]
            cols[d] = cols[d] - pr
            wk.add_flux(v, torch.stack(cols, dim=1))
            wk.add_source(v, -sources[v])

        divu = sum(grads[v][:, d] for d, v in enumerate(vels))
        wk.add_source("pr", divu)

        if self.use_pspg:
            gradp = wk.grad("pr")
            # reference 2D uses tau = alpha*h/(2 visc) (stokes.cpp:256)
            tau = (wk.h if dim == 2 else wk.h * wk.h) / (2.0 * visc)
            stab = torch.stack(
                [tau * (gradp[:, d] + sources[v])
                 for d, v in enumerate(vels)], dim=1)
            wk.add_flux("pr", stab)
        if self.use_lsic:
            tau = wk.h * wk.h / (2.0 * visc)
            s = tau * divu
            wk.add_flux("pr", torch.stack([s] * dim, dim=1))

