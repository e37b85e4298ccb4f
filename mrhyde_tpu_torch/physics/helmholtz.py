"""Frequency-domain Helmholtz with complex coefficients (ureal, uimag).

The port of the JAX package's `mrhyde_tpu/physics/helmholtz.py`
(reference helmholtz.cpp:131-230, the two variables on one basis):
 real eq: (-w2r(ur+ui) + w2i(ui-ur), v)
          + sum_d ((c2r_d(dur+dui) - c2i_d(dui-dur))_d, dv_d)
          - (src_r + src_i, v)
 imag eq: (-w2r(ui-ur) - w2i(ur+ui), v)
          + sum_d ((c2r_d(dui-dur) + c2i_d(dur+dui))_d, dv_d)
          - (src_i - src_r, v)
and the Neumann / Robin (impedance, robin_alpha_r|i) boundary terms of
reference :363-375. No fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Helmholtz"]


@register("helmholtz")
class Helmholtz(PhysicsModule):
    name = "helmholtz"

    def variables(self):
        return [("ureal", "HGRAD", 1), ("uimag", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        for n in ("c2r_x", "c2i_x", "c2r_y", "c2i_y", "c2r_z", "c2i_z",
                  "omega2r", "omega2i", "source_r", "source_i"):
            fm.add_function(n, self._f(fs, n, 0.0), "ip")
        for n in ("robin_alpha_r", "robin_alpha_i", "source_r_side",
                  "source_i_side", "c2r_x", "c2i_x", "c2r_y", "c2i_y",
                  "c2r_z", "c2i_z"):
            fm.add_function(n, self._f(fs, n, 0.0), "side ip")

    def volume_residual(self, wk):
        dim = self.dim
        w2r = wk.qp(wk.f("omega2r"))
        w2i = wk.qp(wk.f("omega2i"))
        sr = wk.qp(wk.f("source_r"))
        si = wk.qp(wk.f("source_i"))
        ur, ui = wk.sol("ureal"), wk.sol("uimag")
        gur, gui = wk.grad("ureal"), wk.grad("uimag")
        c2r = [wk.qp(wk.f(f"c2r_{ax}")) for ax in "xyz"[:dim]]
        c2i = [wk.qp(wk.f(f"c2i_{ax}")) for ax in "xyz"[:dim]]

        wk.add_source("ureal",
                      -w2r * (ur + ui) + w2i * (ui - ur) - (sr + si))
        wk.add_flux("ureal", torch.stack(
            [c2r[d] * (gur[:, d] + gui[:, d])
             - c2i[d] * (gui[:, d] - gur[:, d]) for d in range(dim)],
            dim=1))
        wk.add_source("uimag",
                      -w2r * (ui - ur) - w2i * (ur + ui) - (si - sr))
        wk.add_flux("uimag", torch.stack(
            [c2r[d] * (gui[:, d] - gur[:, d])
             + c2i[d] * (gur[:, d] + gui[:, d]) for d in range(dim)],
            dim=1))

    def boundary_residual(self, wk):
        """On a Neumann (or Robin) side: the impedance terms
        robin_alpha (u, v), the plain and c2-weighted normal derivatives
        (reference helmholtz.cpp boundaryResidual, whose test functions
        vr = vi = phi on the shared basis) and the side sources."""
        bctype = wk.bcs.get("ureal") or wk.bcs.get("uimag")
        if bctype not in ("Neumann", "Robin"):
            return
        dim = self.dim
        rar = wk.qp(wk.f("robin_alpha_r", "side ip"))
        rai = wk.qp(wk.f("robin_alpha_i", "side ip"))
        srs = wk.qp(wk.f("source_r_side", "side ip"))
        sis = wk.qp(wk.f("source_i_side", "side ip"))
        ur, ui = wk.sol("ureal"), wk.sol("uimag")
        gur, gui = wk.grad("ureal"), wk.grad("uimag")
        n = wk.normals
        durdn = (gur * n).sum(dim=1)
        duidn = (gui * n).sum(dim=1)
        c2r = [wk.qp(wk.f(f"c2r_{ax}", "side ip")) for ax in "xyz"[:dim]]
        c2i = [wk.qp(wk.f(f"c2i_{ax}", "side ip")) for ax in "xyz"[:dim]]
        c2durdn = sum((c2r[d] * gur[:, d] - c2i[d] * gui[:, d]) * n[:, d]
                      for d in range(dim))
        c2duidn = sum((c2r[d] * gui[:, d] + c2i[d] * gur[:, d]) * n[:, d]
                      for d in range(dim))
        wk.add_source("ureal",
                      rar * (ur + ui) - rai * (ui - ur)
                      + durdn + duidn - (srs + sis)
                      - (c2durdn + c2duidn))
        wk.add_source("uimag",
                      rar * (ui - ur) + rai * (ur + ui)
                      + duidn - durdn - (sis - srs)
                      - (c2duidn - c2durdn))
