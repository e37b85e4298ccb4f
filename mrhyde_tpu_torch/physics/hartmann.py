"""Hartmann MHD channel flow.

The port of the JAX package's `mrhyde_tpu/physics/hartmann.py`
(reference hartmann.cpp):
  u-eq: -(grad u, grad v) + (Ha db/dx - source u, v)
  b-eq: -(grad b, grad v) + (Ha du/dx, v)
with Ha the function 'hartmannNum' (default 1.0; a function of that name
resolves before a parameter of that name, in both packages), and the
Neumann data on b ADDED to the residual (hartmann.cpp boundaryResidual).
No fused kernel: the general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Hartmann"]


@register("hartmann")
class Hartmann(PhysicsModule):
    name = "hartmann"

    def variables(self):
        return [("u", "HGRAD", 1), ("b", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source u", self._f(fs, "source u", -1.0), "ip")
        fm.add_function("hartmannNum", self._f(fs, "hartmannNum", 1.0),
                        "ip")
        fm.add_function("resistivity", self._f(fs, "resistivity", 1.0),
                        "ip")

    def volume_residual(self, wk):
        ha = wk.qp(wk.f("hartmannNum"))
        wk.add_flux("u", -wk.grad("u"))
        wk.add_source("u", ha * wk.grad("b")[:, 0] - wk.qp(wk.f("source u")))
        wk.add_flux("b", -wk.grad("b"))
        wk.add_source("b", ha * wk.grad("u")[:, 0])

    def boundary_residual(self, wk):
        """Neumann data on b, possibly reading the state, added:
        res += (g, v)."""
        if wk.bcs.get("b") == "Neumann":
            g = wk.qp(wk.f(f"Neumann b {wk.side_name}", "side ip"))
            wk.add_source("b", g)
