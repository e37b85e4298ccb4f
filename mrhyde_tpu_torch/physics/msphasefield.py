"""Multi-species phase field.

The port of the JAX package's `mrhyde_tpu/physics/msphasefield.py`
(reference msphasefield.cpp), per species j (Allen-Cahn with
cross-species interaction):
  (phi_j_t, v) + L (well A phi_j (-phi_j + sum_i phi_i^2), v)
              + L diff^2 (grad phi_j, grad v)
with species phi1..phiN (setting 'number_phases'), L, A and diff read
from the scalar parameters L, A, thermal_diff first and the functions
L, A, diff otherwise. It keeps the reference's quirks: well = 16 in 2D
and 4 in 3D, and by default the frozen first-qp sampling ('legacy
first-qp sampling', 'legacy qp index'). No fused kernel: the general
path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["MSPhasefield"]


def _times(coef, g):
    """coef (a scalar or (Q,)) times the (Q, dim) gradient g."""
    if isinstance(coef, torch.Tensor) and coef.dim() > 0:
        return coef[:, None] * g
    return coef * g


@register("msphasefield")
class MSPhasefield(PhysicsModule):
    name = "msphasefield"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.numphases = int(self.settings.get("number_phases", 1))
        self.phases = [f"phi{i + 1}" for i in range(self.numphases)]

    def variables(self):
        return [(p, "HGRAD", 1) for p in self.phases]

    def define_functions(self, fm, fs):
        fm.add_function("L", self._f(fs, "L", 1.0), "ip")
        fm.add_function("A", self._f(fs, "A", 1.0), "ip")
        fm.add_function("diff", self._f(fs, "diff", 1.0), "ip")

    def _coef(self, wk, pname, fname):
        """The scalar parameter `pname` where the deck has one (the
        reference's updateParameters, msphasefield.cpp:510-524), else
        the function `fname` at the qps."""
        if pname in wk.params:
            return wk.params[pname]
        return wk.qp(wk.f(fname))

    def volume_residual(self, wk):
        L = self._coef(wk, "L", "L")
        A = self._coef(wk, "A", "A")
        diff = self._coef(wk, "thermal_diff", "diff")
        # the reference's well is 16 A in 2D but 4 A in 3D
        # (msphasefield.cpp:298 vs :311)
        well = 16.0 if self.dim == 2 else 4.0
        # The reference appends its per-qp solution values without
        # clearing them (msphasefield.cpp:207-255), so with 'workset
        # size: 1' each element's fields are frozen at its first
        # quadrature point: the parity default, as in the JAX package;
        # 'legacy first-qp sampling: false' gives the consistent form.
        legacy = bool(self.settings.get("legacy first-qp sampling", True))
        if legacy and "legacy first-qp sampling" not in self.settings \
                and not getattr(self, "_warned_legacy", False):
            self._warned_legacy = True
            print("msphasefield: reproducing the reference's frozen "
                  "first-qp sampling (parity default); set 'legacy "
                  "first-qp sampling: false' for the consistent "
                  "weak form")
        # Intrepid2's first tensor-Gauss point is the LAST point of this
        # package's quadrature order (the JAX package's, matched against
        # the 2d-3phi gold)
        qi = int(self.settings.get("legacy qp index", -1))

        def q0(a):
            pick = a[qi:] if qi == -1 else a[qi:qi + 1]
            return pick.expand_as(a)

        phis = [wk.sol(p) for p in self.phases]
        if legacy:
            phis = [q0(p) for p in phis]
        sumphi = sum(p * p for p in phis)
        for j, name in enumerate(self.phases):
            pdot = wk.sol_dot(name)
            g = wk.grad(name)
            if legacy:
                pdot = q0(pdot)
                g = q0(g)
            wk.add_source(name, pdot
                          + L * well * A * phis[j] * (-phis[j] + sumphi))
            wk.add_flux(name, _times(L * diff * diff, g))
