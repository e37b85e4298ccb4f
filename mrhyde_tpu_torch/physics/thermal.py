"""Thermal (heat equation) physics module.

Weak form (the JAX package's `mrhyde_tpu/physics/thermal.py`, reference
thermal.cpp:71-166):  (rho cp dT/dt - f, v) + (kappa grad T, grad v).
The advection option and the boundary terms (Neumann, weak Dirichlet,
multiscale interface) are not ported yet and raise.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Thermal"]


@register("thermal")
class Thermal(PhysicsModule):
    name = "thermal"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        if bool(self.settings.get("include advection", False)):
            raise NotImplementedError(
                "thermal 'include advection' is not ported to "
                "mrhyde_tpu_torch yet (ROADMAP A10)")

    def variables(self):
        return [("e", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("thermal source", self._f(fs, "thermal source", 0.0),
                        "ip")
        fm.add_function("thermal diffusion",
                        self._f(fs, "thermal diffusion", 1.0), "ip")
        fm.add_function("specific heat", self._f(fs, "specific heat", 1.0),
                        "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")

    def volume_residual(self, wk):
        rho = wk.f("density")
        cp = wk.f("specific heat")
        kappa = wk.f("thermal diffusion")
        source = wk.f("thermal source")
        sval = rho * cp * wk.sol_dot("e") - source
        wk.add_source("e", sval)
        wk.add_flux("e", wk.qp(kappa)[:, None] * wk.grad("e"))

    def qp_coefficients(self, q):
        """(S, kappa) at quadrature points, with S = rho cp u_t - f and
        flux kappa grad u: what the fused thermal kernels consume
        (ops/fused_p1.py)."""
        sval = q.f("density") * q.f("specific heat") * q.sol_dot("e") \
            - q.f("thermal source")
        return sval, q.f("thermal diffusion")

    def qp_mass(self, q):
        """The mass coefficient rho cp at quadrature points: d S / d u_t,
        what the fused thermal kernels weight u_dot's lane with."""
        return q.f("density") * q.f("specific heat")

    def qp_density(self, q):
        """Per-qp (source, flux) densities — the same weak form as
        volume_residual, in the JAX package's qp_density form."""
        sval, kap = self.qp_coefficients(q)
        g = q.grad("e")
        return {"e": (sval, [kap * g[d] for d in range(self.dim)])}
