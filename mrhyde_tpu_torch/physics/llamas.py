"""The llamas module, the reference's pedagogical reaction-diffusion
example (llamas.hpp), as the JAX package's `mrhyde_tpu/physics/llamas.py`:
(grad llama, grad v) + (c llama - source, v), with c the deck's function
'c' and the source its function 'whatever'. No fused kernel: the
general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Llamas"]


@register("llamas")
class Llamas(PhysicsModule):
    name = "llamas"

    def variables(self):
        return [("llama", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("sourceterm", self._f(fs, "whatever", 0.0), "ip")
        fm.add_function("cterm", self._f(fs, "c", 0.0), "ip")

    def volume_residual(self, wk):
        wk.add_flux("llama", wk.grad("llama"))
        wk.add_source("llama", wk.qp(wk.f("cterm")) * wk.sol("llama")
                      - wk.qp(wk.f("sourceterm")))
