"""Convection-diffusion-reaction physics module.

Weak form (the JAX package's `mrhyde_tpu/physics/cdr.py`, reference
cdr.cpp:63-145):
  (c_t + v . grad c + reaction - source, w)
  + (diffusion/(rho cp) grad c, grad w)
The reaction function may reference the solution (e.g. '0.5*c*c'),
making the problem nonlinear. `c_t` carries no rho cp weight. The
velocity components default to 1.0; `SUPG tau` is defined but unused, as
in the JAX package. cdr has no boundary terms of its own, as in JAX: a
Flux condition on c is the assembler's physics-agnostic term.
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["CDR"]

_VELOCITY = ("xvel", "yvel", "zvel")


@register("cdr")
class CDR(PhysicsModule):
    name = "cdr"

    def variables(self):
        return [("c", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0), "ip")
        fm.add_function("specific heat", self._f(fs, "specific heat", 1.0),
                        "ip")
        fm.add_function("density", self._f(fs, "density", 1.0), "ip")
        fm.add_function("reaction", self._f(fs, "reaction", 1.0), "ip")
        fm.add_function("xvel", self._f(fs, "xvel", 1.0), "ip")
        fm.add_function("yvel", self._f(fs, "yvel", 1.0), "ip")
        fm.add_function("zvel", self._f(fs, "zvel", 1.0), "ip")
        fm.add_function("SUPG tau", self._f(fs, "SUPG tau", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 1.0),
                        "side ip")
        fm.add_function("robin alpha", self._f(fs, "robin alpha", 0.0),
                        "side ip")

    def volume_residual(self, wk):
        source = wk.f("source")
        diff = wk.f("diffusion")
        cp = wk.f("specific heat")
        rho = wk.f("density")
        reax = wk.f("reaction")
        c_t = wk.sol_dot("c")
        gradc = wk.grad("c")
        adv = wk.qp(wk.f("xvel")) * gradc[:, 0]
        if self.dim > 1:
            adv = adv + wk.qp(wk.f("yvel")) * gradc[:, 1]
        if self.dim > 2:
            adv = adv + wk.qp(wk.f("zvel")) * gradc[:, 2]
        wk.add_source("c", c_t + adv + reax - source)
        wk.add_flux("c", wk.qp(diff / (rho * cp))[:, None] * gradc)

    # -- the fused provider's hooks (ops/fused_p1.py) ---------------------

    def fused_names(self):
        """The functions behind each coefficient of the fused kernels:
        kappa, S (without advection), the mass m (none: it is 1) and the
        velocity."""
        return {"kappa": ("diffusion", "density", "specific heat"),
                "source": ("reaction", "source"), "mass": (),
                "velocity": _VELOCITY[:self.dim]}

    def kernel_coefficients(self):
        """The functions behind each coefficient of the generated
        module-set kernel (functions/codegen.py, scalar_density.cuh
        cdr_density)."""
        return {"kind": "cdr", "diff": "diffusion", "rho": "density",
                "cp": "specific heat", "reaction": "reaction",
                "f": "source", "b": _VELOCITY[:self.dim]}

    def qp_coefficients(self, q):
        """(S, kappa) at quadrature points without the advection term: S
        = c_t + reaction - source, kappa = diffusion / (rho cp)."""
        sval = q.sol_dot("c") + q.f("reaction") - q.f("source")
        return sval, q.f("diffusion") / (q.f("density")
                                         * q.f("specific heat"))

    def qp_mass(self, q):
        """d S / d c_t: 1, c_t carries no rho cp weight."""
        return 1.0

    def qp_velocity(self, q):
        """The advection velocity's `dim` components at quadrature
        points."""
        return [q.f(n) for n in _VELOCITY[:self.dim]]

    def qp_density(self, q):
        """Per-qp (source, flux) densities — the same weak form as
        volume_residual, in the JAX package's qp_density form and order
        of operations (the module-set provider sums them)."""
        g = q.grad("c")
        adv = sum(b * g[d] for d, b in enumerate(self.qp_velocity(q)))
        sval = q.sol_dot("c") + adv + q.f("reaction") - q.f("source")
        kap = q.f("diffusion") / (q.f("density") * q.f("specific heat"))
        return {"c": (sval, [kap * g[d] for d in range(self.dim)])}
