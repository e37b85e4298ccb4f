"""The physicsTest module (reference physics_test.cpp), as the JAX
package's `mrhyde_tpu/physics/physics_test.py`: a procedural module
whose residual is plain diffusion, (e_t - test source, v) + (grad e,
grad v), to validate the pipeline. No fused kernel: the general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["PhysicsTest"]


@register("physicsTest")
class PhysicsTest(PhysicsModule):
    name = "physicsTest"

    def variables(self):
        return [("e", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("test source", self._f(fs, "test source", 0.0),
                        "ip")

    def volume_residual(self, wk):
        wk.add_source("e", wk.sol_dot("e") - wk.qp(wk.f("test source")))
        wk.add_flux("e", wk.grad("e"))
