"""Incompressible Navier-Stokes physics module (equal-order SUPG/PSPG).

The port of the JAX package's `mrhyde_tpu/physics/navierstokes.py`
(reference src/physics/navierstokes.cpp:95-520):
  momentum d: (visc grad(u_d) - p e_d, grad v)
              + (rho (u_d_t + u . grad u_d - source_d), v)
              [+ SUPG: (tau stabres_d u, grad v)]
  continuity: (div u, q) [+ PSPG: (tau stabres / rho, grad q)]
  stabres_d = rho u_d_t + rho u . grad u_d + dp/dx_d - rho source_d
  tau = 1/sqrt((C1 visc/h^2)^2 + (C2 |u|/h)^2 + (C3/dt)^2),
  C1=4, C2=2, C3 = 2 if transient else 0 (navierstokes.cpp computeTau).
With a temperature variable `e` in the set (thermal), the Boussinesq
term rho beta (e - T_ambient) source_d joins momentum equation d and
its strong residual stabres_d (navierstokes.cpp:134-147, :231; settings
`beta`, default 1, and `T_ambient`, default 0).

`ns_density` is the qp weak form the fused providers and their CUDA
kernels (ops/fused_ns.py, ops/fused_set.py, ops/csrc/ns_density.cuh)
evaluate; `volume_residual` is the general path's workset form of the
same equations, and `qp_density` the fused module-set form.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.ops.sparse_dual import sqrt_, where_
from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["NavierStokes", "ns_density", "tau"]

_VELS = ["ux", "uy", "uz"]


def tau(visc, u2, h, deltat, is_transient):
    """The SUPG/PSPG stabilisation parameter. |u| takes the u2 branch
    where u2 <= 1e-12, so the first Newton step from rest never
    differentiates sqrt at 0."""
    c1, c2 = 4.0, 2.0
    c3 = 2.0 if is_transient else 0.0
    nvel = where_(u2 > 1e-12, sqrt_(u2), u2)
    t2 = ((c1 * visc / (h * h)) ** 2 + (c2 * nvel / h) ** 2
          + (c3 / deltat) ** 2)
    return 1.0 / sqrt_(t2)


def ns_density(u, ud, g, pr, gp, rho, visc, src, h, deltat, is_transient,
               pspg, supg, buoy=None):
    """Per-qp (source, flux) densities {var: (S, [F_d])} of the weak form
    above. u, ud, g, src: per-velocity lists (g[i] the gradient list of
    velocity i); pr, gp: pressure and its gradient; buoy: the Boussinesq
    factor rho beta (e - T_ambient), or None without a temperature.
    Values may be tensors, Python floats or SDuals."""
    dim = len(u)
    vels = _VELS[:dim]
    conv = [sum(u[d] * g[i][d] for d in range(dim)) for i in range(dim)]
    out = {}
    for i, v in enumerate(vels):
        F = [visc * g[i][k] for k in range(dim)]
        F[i] = F[i] - pr
        S = rho * (ud[i] + conv[i] - src[i])
        out[v] = (S if buoy is None else S + buoy * src[i], F)
    divu = sum(g[i][i] for i in range(dim))
    Fpr = None
    if supg or pspg:
        u2 = sum(u[i] * u[i] for i in range(dim))
        t = tau(visc, u2, h, deltat, is_transient)
        stab = [rho * ud[i] + rho * conv[i] + gp[i] - rho * src[i]
                for i in range(dim)]
        if buoy is not None:
            stab = [s + buoy * src[i] for i, s in enumerate(stab)]
    if supg:
        for i, v in enumerate(vels):
            S, F = out[v]
            out[v] = (S, [F[d] + t * stab[i] * u[d] for d in range(dim)])
    if pspg:
        Fpr = [t * stab[i] / rho for i in range(dim)]
    out["pr"] = (divu, Fpr)
    return out


@register("navier stokes")
class NavierStokes(PhysicsModule):
    name = "navierstokes"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.use_supg = bool(self.settings.get("useSUPG", False))
        self.use_pspg = bool(self.settings.get("usePSPG", False))
        self.beta = float(self.settings.get("beta", 1.0))
        self.t_ambient = float(self.settings.get("T_ambient", 0.0))

    def variables(self):
        out = [("ux", "HGRAD", 1), ("pr", "HGRAD", 1)]
        if self.dim > 1:
            out.insert(1, ("uy", "HGRAD", 1))
        if self.dim > 2:
            out.insert(2, ("uz", "HGRAD", 1))
        return out

    def define_functions(self, fm, fs):
        for v in ("ux", "pr", "uy", "uz"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")
        fm.add_function("viscosity", self._f(fs, "viscosity", 1.0), "ip")

    def volume_residual(self, wk):
        dim = self.dim
        vels = _VELS[:dim]
        rho = wk.qp(wk.f("density"))
        visc = wk.qp(wk.f("viscosity"))
        src = [wk.qp(wk.f(f"source {v}")) for v in vels]
        grads = [wk.grad(v) for v in vels]
        gp = wk.grad("pr")
        buoy = None
        if "e" in wk.offsets:
            buoy = rho * self.beta * (wk.sol("e") - self.t_ambient)
        out = ns_density(
            [wk.sol(v) for v in vels], [wk.sol_dot(v) for v in vels],
            [[gr[:, d] for d in range(dim)] for gr in grads], wk.sol("pr"),
            [gp[:, d] for d in range(dim)], rho, visc, src, wk.h,
            wk.deltat, wk.is_transient, self.use_pspg, self.use_supg, buoy)
        for v in vels + ["pr"]:
            S, F = out[v]
            wk.add_source(v, S)
            if F is not None:
                wk.add_flux(v, torch.stack(F, dim=1))

    def kernel_coefficients(self):
        """The functions behind each coefficient of the generated
        module-set kernel (functions/codegen.py, ns_density.cuh)."""
        return {"kind": "ns", "rho": "density", "visc": "viscosity",
                "src": tuple(f"source {v}" for v in _VELS[:self.dim])}

    def qp_density(self, q):
        """Per-qp (source, flux) densities at a fused context q (the JAX
        package's `qp_density`): what the module-set provider sums
        (ops/fused_set.py). The Boussinesq term enters when the set has
        `e`."""
        vels = _VELS[:self.dim]
        rho, visc = q.f("density"), q.f("viscosity")
        buoy = None
        if q.has("e"):
            buoy = rho * self.beta * (q.sol("e") - self.t_ambient)
        return ns_density(
            [q.sol(v) for v in vels], [q.sol_dot(v) for v in vels],
            [q.grad(v) for v in vels], q.sol("pr"), q.grad("pr"), rho,
            visc, [q.f(f"source {v}") for v in vels], q.h, q.deltat,
            q.is_transient, self.use_pspg, self.use_supg, buoy)
