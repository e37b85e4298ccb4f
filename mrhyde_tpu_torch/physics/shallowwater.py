"""Shallow water equations (conservative form, 2D).

The port of the JAX package's `mrhyde_tpu/physics/shallowwater.py`
(reference shallowwater.cpp:95-180):
  (xi_t - source_H, w) - (Hu, wx) - (Hv, wy)
  (Hu_t - g xi bath_x - source_Hu, w)
      - (Hu^2/H + g/2 (H^2 - b^2), wx) - (Hu Hv / H, wy)
  (Hv_t - g xi bath_y - source_Hv, w)
      - (Hu Hv / H, wx) - (Hv^2/H + g/2 (H^2 - b^2), wy)
with H = xi + bathymetry and g the setting 'gravity' (default 9.8). No
fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["ShallowWater"]


@register("shallow water")
class ShallowWater(PhysicsModule):
    name = "shallowwater"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.gravity = float(self.settings.get("gravity", 9.8))

    def variables(self):
        return [("H", "HGRAD", 1), ("Hu", "HGRAD", 1), ("Hv", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        for n, d in (("bathymetry", 1.0), ("bathymetry_x", 0.0),
                     ("bathymetry_y", 0.0), ("bottom friction", 1.0),
                     ("viscosity", 0.0), ("Coriolis", 0.0)):
            fm.add_function(n, self._f(fs, n, d), "ip")
        for v in ("H", "Hu", "Hv"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")

    def volume_residual(self, wk):
        g = self.gravity
        bath = wk.qp(wk.f("bathymetry"))
        bath_x = wk.qp(wk.f("bathymetry_x"))
        bath_y = wk.qp(wk.f("bathymetry_y"))
        xi = wk.sol("H")
        Hu = wk.sol("Hu")
        Hv = wk.sol("Hv")
        H = xi + bath
        uHu, uHv, vHv = Hu * Hu / H, Hu * Hv / H, Hv * Hv / H
        pres = 0.5 * g * (H * H - bath * bath)

        wk.add_source("H", wk.sol_dot("H") - wk.qp(wk.f("source H")))
        wk.add_flux("H", torch.stack([-Hu, -Hv], dim=1))

        wk.add_source("Hu", wk.sol_dot("Hu") - g * xi * bath_x
                      - wk.qp(wk.f("source Hu")))
        wk.add_flux("Hu", torch.stack([-(uHu + pres), -uHv], dim=1))

        wk.add_source("Hv", wk.sol_dot("Hv") - g * xi * bath_y
                      - wk.qp(wk.f("source Hv")))
        wk.add_flux("Hv", torch.stack([-uHv, -(vHv + pres)], dim=1))
