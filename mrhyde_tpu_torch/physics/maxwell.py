"""Maxwell's equations: HCURL electric field E + HDIV magnetic field B.

The port of the JAX package's `mrhyde_tpu/physics/maxwell.py` (reference
maxwell.cpp volumeResidual):
  B-eq (HDIV, 3D / HVOL, 2D):  (B_t + curl E, w)
  E-eq (HCURL): (n^2 E_t + (sigma E + J)/eps, v) - (B/(mu eps), curl v)
(the reference folds 1/eps into the E equation in 3D; 2D keeps eps on
the time term). Registered as 'maxwell' and 'maxwell control' (the same
E-B weak form, its current J read from the deck's functions and
parameters). No fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Maxwell"]


@register("maxwell")
@register("maxwell control")
class Maxwell(PhysicsModule):
    name = "maxwell"

    def variables(self):
        if self.dim == 2:
            return [("E", "HCURL", 1), ("B", "HVOL", 0)]
        return [("E", "HCURL", 1), ("B", "HDIV", 1)]

    def define_functions(self, fm, fs):
        for name, key, default in (
                ("current x", "current x", 0.0),
                ("current y", "current y", 0.0),
                ("current z", "current z", 0.0),
                ("mu", "permeability", 1.0),
                ("epsilon", "permittivity", 1.0),
                ("refractive index", "refractive index", 1.0),
                ("sigma", "conductivity", 0.0)):
            fm.add_function(name, self._f(fs, key, default), "ip")

    def volume_residual(self, wk):
        mu = wk.qp(wk.f("mu"))
        eps = wk.qp(wk.f("epsilon"))
        n = wk.qp(wk.f("refractive index"))
        sig = wk.qp(wk.f("sigma"))
        E = wk.sol("E")                  # (Q, dim)
        E_t = wk.sol_dot("E")
        curlE = wk.curl("E")             # (Q,) 2D / (Q, 3) 3D
        B = wk.sol("B")                  # (Q,) 2D / (Q, 3) 3D
        B_t = wk.sol_dot("B")
        J = torch.stack([wk.qp(wk.f(f"current {c}"))
                         for c in "xyz"[:self.dim]], dim=1)
        if self.dim == 2:
            wk.add_source("B", B_t + curlE)
            wk.add_vec_source("E", (eps * n * n)[:, None] * E_t
                              + sig[:, None] * E + J)
            wk.add_curl_source("E", -B / mu)
        else:
            wk.add_vec_source("B", B_t + curlE)
            wk.add_vec_source("E", (n * n)[:, None] * E_t
                              + (sig[:, None] * E + J) / eps[:, None])
            wk.add_curl_source("E", -B / (mu * eps)[:, None])
