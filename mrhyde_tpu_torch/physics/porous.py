"""Single-phase porous media flow (slightly compressible Darcy), HGRAD.

The port of the JAX package's `mrhyde_tpu/physics/porous.py` (reference
porous.cpp volumeResidual):
  (phi rho_ref c p_t - source, w)
  + (K/mu rho_ref (1 + c (p - p_ref)) grad p, grad w)
No fused kernel: the general path, as in the JAX package.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Porous"]


@register("porous")
class Porous(PhysicsModule):
    name = "porous"

    def variables(self):
        return [("p", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "porous source", 0.0), "ip")
        for n, d in (("permeability", 1.0), ("porosity", 1.0),
                     ("viscosity", 1.0), ("reference density", 1.0),
                     ("reference pressure", 1.0), ("compressibility", 0.0),
                     ("gravity", 1.0)):
            fm.add_function(n, self._f(fs, n, d), "ip")
        for n in ("source", "permeability", "viscosity"):
            key = "porous source" if n == "source" else n
            fm.add_function(n, self._f(fs, key,
                                       0.0 if n == "source" else 1.0),
                            "side ip")

    def volume_residual(self, wk):
        perm = wk.qp(wk.f("permeability"))
        poro = wk.qp(wk.f("porosity"))
        visc = wk.qp(wk.f("viscosity"))
        densref = wk.qp(wk.f("reference density"))
        pref = wk.qp(wk.f("reference pressure"))
        comp = wk.qp(wk.f("compressibility"))
        source = wk.qp(wk.f("source"))
        p = wk.sol("p")
        Kdens = perm / visc * densref * (1.0 + comp * (p - pref))
        wk.add_source("p", poro * densref * comp * wk.sol_dot("p") - source)
        wk.add_flux("p", Kdens[:, None] * wk.grad("p"))
