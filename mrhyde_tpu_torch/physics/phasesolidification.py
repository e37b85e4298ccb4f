"""Phase solidification (a multi-phase Allen-Cahn variant).

The port of the JAX package's `mrhyde_tpu/physics/phasesolidification.py`
(reference phasesolidification.hpp:166-230), per phase j:
  (phi_j_t, v) + L (16 A phi_j (-phi_j + sum_i phi_i^2), v)
               + L diff^2 (grad phi_j, grad v)
It differs from msphasefield as the reference does: the well is 16 A in
every dimension, the 3D gradient term counts the z part twice
(phasesolidification.hpp:224-225), and there is no first-qp sampling
(the per-qp values are declared inside the quadrature loop). L, A and
diff come from the parameters L, A, thermal_diff first, the functions
otherwise. No fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.msphasefield import MSPhasefield, _times
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["PhaseSolidification"]


@register("phasesolidification")
class PhaseSolidification(MSPhasefield):
    name = "phasesolidification"

    def volume_residual(self, wk):
        L = self._coef(wk, "L", "L")
        A = self._coef(wk, "A", "A")
        diff = self._coef(wk, "thermal_diff", "diff")
        phis = [wk.sol(p) for p in self.phases]
        sumphi = sum(p * p for p in phis)
        for j, name in enumerate(self.phases):
            g = wk.grad(name)
            wk.add_source(name, wk.sol_dot(name)
                          + L * 16.0 * A * phis[j] * (-phis[j] + sumphi))
            flux = _times(L * diff * diff, g)
            if self.dim > 2:
                # the reference doubles the z term
                flux = flux * torch.tensor([1.0, 1.0, 2.0],
                                           dtype=g.dtype, device=g.device)
            wk.add_flux(name, flux)
