"""ODE physics module: solves q_dot = f(q, t) per element.

The port of the JAX package's `mrhyde_tpu/physics/ode.py` (reference
src/physics/ode.cpp): HVOL variable 'q', res = (q_dot - source, v).
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["ODE"]


@register("ODE")
class ODE(PhysicsModule):
    name = "ode"

    def variables(self):
        return [("q", "HVOL", 0)]

    def define_functions(self, fm, fs):
        fm.add_function("ODE source", self._f(fs, "ODE source", 0.0), "ip")

    def volume_residual(self, wk):
        source = wk.f("ODE source")
        wk.add_source("q", wk.sol_dot("q") - source)
