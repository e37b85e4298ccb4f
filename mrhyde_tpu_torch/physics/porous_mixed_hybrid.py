"""Hybridized mixed-form porous flow: broken HDIV u + HVOL p + HFACE
trace lambda.

The port of the JAX package's `mrhyde_tpu/physics/porous_mixed_hybrid.py`
(reference porousMixedHybridized.cpp). The velocity space is
element-local (HDIV-DG); normal continuity is enforced weakly by the
facet trace variable lambda:
  u-eq: (Kinv u, v) - (p, div v) + sum_sides <lambda, v.n>
  p-eq: (div u - source, q)
  lambda-eq: -sum_sides <u.n, mu>     (flux continuity per facet)
Dirichlet pressure data fixes the boundary trace dofs (lambda = p_D).
Algebraically the conforming mixed method, so it reproduces its error
norms. No fused kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["PorousMixedHybrid"]


@register("porous mixed hybridized")
class PorousMixedHybrid(PhysicsModule):
    name = "porousMixedHybrid"

    def variables(self):
        return [("p", "HVOL", 0), ("u", "HDIV-DG", 1),
                ("lambda", "HFACE", 0)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        for k in ("Kinv_xx", "Kinv_yy", "Kinv_zz"):
            fm.add_function(k, self._f(fs, k, 1.0), "ip")

    def volume_residual(self, wk):
        dim = self.dim
        Kinv = [wk.qp(wk.f(k))
                for k in ("Kinv_xx", "Kinv_yy", "Kinv_zz")[:dim]]
        u = wk.sol("u")
        p = wk.sol("p")
        wk.add_vec_source("u", torch.stack([Kinv[d] * u[:, d]
                                            for d in range(dim)], dim=1))
        wk.add_div_source("u", -p)
        wk.add_source("p", wk.div("u") - wk.qp(wk.f("source")))
        # facet coupling terms over every element side
        for s in range(wk.n_sides()):
            lam = wk.trace("lambda", s)
            n = wk.face_normals[s]                    # (Qf, dim)
            wk.add_face_vec_source("u", s, lam[..., None] * n)
            udotn = (wk.face_sol_vec("u", s) * n).sum(dim=1)
            wk.add_trace_source("lambda", s, -udotn)
