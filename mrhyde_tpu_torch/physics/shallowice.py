"""Shallow-ice approximation.

The port of the JAX package's `mrhyde_tpu/physics/shallowice.py`
(reference shallowice.cpp): (s_t - source, v) + (diffusion grad s,
grad v). No fused kernel: the general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["ShallowIce"]


@register("shallow ice")
class ShallowIce(PhysicsModule):
    name = "shallowice"

    def variables(self):
        return [("s", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0),
                        "side ip")

    def volume_residual(self, wk):
        wk.add_source("s", wk.sol_dot("s") - wk.qp(wk.f("source")))
        wk.add_flux("s", wk.qp(wk.f("diffusion"))[:, None] * wk.grad("s"))
