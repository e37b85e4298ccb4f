"""Weak Galerkin porous (Darcy) flow.

The port of the JAX package's `mrhyde_tpu/physics/porous_weak_galerkin.py`
(reference porousWeakGalerkin.cpp): variables pint (HVOL), pbndry
(HFACE), u (the weak gradient) and t (the flux), both HDIV-DG, or with
'useAC' the Arbogast-Correa HDIV_AC-DG:
  u-eq: (u, v) + (pint, div v) - sum_sides <pbndry, v.n>   [weak grad]
  t-eq: (K u + t, s)                                       [flux law]
  pint-eq: (div t - source, q)
  pbndry-eq: -sum_sides <t.n, mu>                          [continuity]
The permeability is the function 'permeability', or the mesh data file's
column under 'use permeability data'. As a multiscale fine problem the
"interface" sides couple u to the macro trace and t.n is the upscaled
flux. No fused kernel: the general path.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["PorousWeakGalerkin"]


@register("porous weak Galerkin")
class PorousWeakGalerkin(PhysicsModule):
    name = "porousWeakGalerkin"

    def variables(self):
        vec = "HDIV_AC-DG" if self.settings.get("useAC", False) \
            else "HDIV-DG"
        return [("pint", "HVOL", 0), ("pbndry", "HFACE", 0),
                ("u", vec, 1), ("t", vec, 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        fm.add_function("perm", self._f(fs, "permeability", 1.0), "ip")

    def volume_residual(self, wk):
        if self.settings.get("use permeability data", False):
            perm = wk.qp(wk.extra_fields["mesh_data"])
        else:
            perm = wk.qp(wk.f("perm"))
        u = wk.sol("u")
        t = wk.sol("t")
        # weak-gradient definition
        wk.add_vec_source("u", u)
        wk.add_div_source("u", wk.sol("pint"))
        # flux law t = -K u
        wk.add_vec_source("t", perm[:, None] * u + t)
        # conservation
        wk.add_source("pint", wk.div("t") - wk.qp(wk.f("source")))
        # facet terms (none where 'Active variables' leaves pbndry out)
        if "pbndry" not in wk.offsets:
            return
        for s in range(wk.n_sides()):
            pb = wk.trace("pbndry", s)
            n = wk.face_normals[s]
            wk.add_face_vec_source("u", s, -pb[..., None] * n)
            wk.add_trace_source("pbndry", s,
                                -(wk.face_sol_vec("t", s) * n).sum(dim=1))

    def boundary_residual(self, wk):
        if wk.bcs.get("pint") == "interface":
            # the multiscale coupling: the macro trace acts as the
            # boundary pressure of the weak gradient (reference
            # porousWeakGalerkin.cpp:393-415, res_u -= <lambda, v.n>)
            lam = wk.qp(wk.resolve("aux pint"))
            wk.add_vec_source("u", -lam[:, None] * wk.normals)

    def compute_flux(self, wk):
        """The upscaled flux of the multiscale coupling, t.n (reference
        porousWeakGalerkin.cpp:515-553 computeFlux)."""
        return {"pint": (wk.sol("t") * wk.normals).sum(dim=1)}
