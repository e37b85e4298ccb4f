"""Two-phase incompressible saturation transport.

The port of the JAX package's
`mrhyde_tpu/physics/incompressible_saturation.py` (reference
incompressibleSaturation.cpp): (phi S_t, v) - (f_w u, grad v) -
(source_S, v), with the constant porosity phi (setting 'porosity',
default 0.5), the velocity functions ux, uy, uz, and with 'use well
source' the Peaceman wells of `wells.py` (reference :40-41, :88-92). No
fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register
from mrhyde_tpu_torch.physics.wells import Wells

__all__ = ["IncompressibleSaturation"]

_VELOCITY = ("ux", "uy", "uz")


@register("inc sat")
class IncompressibleSaturation(PhysicsModule):
    name = "incompressibleSaturation"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.phi = float(self.settings.get("porosity", 0.5))
        self.wells = Wells(self.settings) \
            if bool(self.settings.get("use well source", False)) else None

    def variables(self):
        return [("S", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source_S", self._f(fs, "source_S", 0.0), "ip")
        fm.add_function("f_w", self._f(fs, "f_w", 1.0), "ip")
        for v in _VELOCITY[:self.dim]:
            fm.add_function(v, self._f(fs, v, 0.0), "ip")

    def volume_residual(self, wk):
        fw = wk.qp(wk.f("f_w"))
        vel = [wk.qp(wk.f(v)) for v in _VELOCITY[:self.dim]]
        src = wk.qp(wk.f("source_S"))
        if self.wells is not None:
            src = self.wells.add_sources(src, wk)
        wk.add_source("S", self.phi * wk.sol_dot("S") - src)
        wk.add_flux("S", -fw[:, None] * torch.stack(vel, dim=1))
