"""Kuramoto-Sivashinsky in its mixed second-order form.

The port of the JAX package's `mrhyde_tpu/physics/kuramoto_sivashinsky.py`
(reference kuramotoSivashinsky.cpp):
  u-eq: (u_t + w + 0.5 |grad u|^2, v) - (grad w, grad v)
  w-eq: (w, v) + (grad u, grad v)        [w = laplacian(u)]
No fused kernel: the general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["KuramotoSivashinsky"]


@register("Kuramoto-Sivashinsky")
class KuramotoSivashinsky(PhysicsModule):
    name = "kuramotoSivashinsky"

    def variables(self):
        return [("u", "HGRAD", 1), ("w", "HGRAD", 1)]

    def volume_residual(self, wk):
        gu = wk.grad("u")
        gradu_sq = 0.5 * (gu * gu).sum(dim=1)
        wk.add_source("u", wk.sol_dot("u") + wk.sol("w") + gradu_sq)
        wk.add_flux("u", -wk.grad("w"))
        wk.add_source("w", wk.sol("w"))
        wk.add_flux("w", gu)
