"""Thermal (heat equation) physics module.

Weak form (the JAX package's `mrhyde_tpu/physics/thermal.py`, reference
thermal.cpp:71-166):  (rho cp dT/dt - f, v) + (kappa grad T, grad v),
plus (b . grad T, v) with 'include advection' (b = the functions bx, by,
bz: deck keys 'advection x|y|z', default 0). Boundary terms
(`boundary_residual`, reference thermal.cpp boundaryResidual): Neumann
-(g, v)_Gamma, the Nitsche-type weak Dirichlet terms and the multiscale
"interface" coupling to the macro trace, whose upscaled flux is
`compute_flux` (multiscale/subgrid.py).
"""

from __future__ import annotations

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Thermal"]

_VELOCITY = ("bx", "by", "bz")


@register("thermal")
class Thermal(PhysicsModule):
    name = "thermal"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.have_advection = bool(self.settings.get("include advection",
                                                     False))
        self.form_param = float(self.settings.get("form_param", 1.0))

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
        fm.add_function("thermal diffusion",
                        self._f(fs, "thermal diffusion", 1.0), "side ip")
        fm.add_function("robin alpha", self._f(fs, "robin alpha", 0.0),
                        "side ip")
        if self.have_advection:
            fm.add_function("bx", self._f(fs, "advection x", 0.0), "ip")
            fm.add_function("by", self._f(fs, "advection y", 0.0), "ip")
            fm.add_function("bz", self._f(fs, "advection z", 0.0), "ip")

    def volume_residual(self, wk):
        rho = wk.f("density")
        cp = wk.f("specific heat")
        kappa = wk.f("thermal diffusion")
        source = wk.f("thermal source")
        grad = wk.grad("e")
        sval = rho * cp * wk.sol_dot("e") - source
        if self.have_advection:
            for d, bn in enumerate(_VELOCITY[:self.dim]):
                sval = sval + wk.f(bn) * grad[:, d]
        wk.add_source("e", sval)
        wk.add_flux("e", wk.qp(kappa)[:, None] * grad)

    def boundary_residual(self, wk):
        """The side terms of e's condition on this sideset: Neumann
        -(g, v); weak Dirichlet (Nitsche, as the JAX package and the
        reference): -(kappa grad e . n, v) - sf (e - g, kappa grad v . n)
        + (10/h_side kappa (e - g), v), with g the function 'Dirichlet e
        <sideset>' and sf the module's form_param."""
        bctype = wk.bcs.get("e")
        if bctype == "Neumann":
            g = wk.f(f"Neumann e {wk.side_name}", "side ip")
            wk.add_source("e", -wk.qp(g))
        elif bctype == "interface":
            # the multiscale coupling to the macro trace lambda ("aux
            # e"): Nitsche terms with epen = 10 (reference
            # thermal.cpp:227-286)
            kappa = wk.qp(wk.f("thermal diffusion", "side ip"))
            lam = wk.qp(wk.resolve("aux e"))
            T = wk.sol("e")
            n = wk.normals
            fluxn = kappa * (wk.grad("e") * n).sum(dim=1)
            wk.add_source("e", 10.0 / wk.side_h * kappa * (T - lam) - fluxn)
            dgn = (wk.basis_grad("e") * n[None, :, :]).sum(dim=2)
            wk.add("e", -self.form_param
                   * (dgn * (kappa * (T - lam) * wk.wts)[None, :]).sum(dim=1))
        elif bctype == "weak Dirichlet":
            kappa = wk.f("thermal diffusion", "side ip")
            g = wk.f(f"Dirichlet e {wk.side_name}", "side ip")
            T = wk.sol("e")
            n = wk.normals
            fluxn = kappa * (wk.grad("e") * n).sum(dim=1)
            wk.add_source("e", -fluxn)
            dgn = (wk.basis_grad("e") * n[None, :, :]).sum(dim=2)
            wk.add("e", -self.form_param
                   * (dgn * (kappa * (T - g) * wk.wts)[None, :]).sum(dim=1))
            wk.add_source("e", 10.0 / wk.side_h * wk.qp(kappa) * (T - g))

    def compute_flux(self, wk):
        """The upscaled flux of the multiscale coupling (reference
        thermal.cpp:288-345 computeFlux): epen/h kappa (lambda - T) + sf
        kappa grad T . n, with epen = 10 and sf = 1."""
        kappa = wk.qp(wk.f("thermal diffusion", "side ip"))
        lam = wk.qp(wk.resolve("aux e"))
        return {"e": 10.0 / wk.side_h * kappa * (lam - wk.sol("e"))
                + kappa * (wk.grad("e") * wk.normals).sum(dim=1)}

    # -- the fused provider's hooks (ops/fused_p1.py) ---------------------

    def fused_names(self):
        """The functions behind each coefficient of the fused kernels:
        kappa, S (without advection), the mass m and the velocity."""
        return {"kappa": ("thermal diffusion",),
                "source": ("thermal source", "density", "specific heat"),
                "mass": ("density", "specific heat"),
                "velocity": _VELOCITY[:self.dim] if self.have_advection
                else ()}

    def setup_integrated_quantities(self, dim):
        """The module's test integrated quantities (reference
        thermal.cpp:422), with 'test integrated quantities'."""
        if not self.settings.get("test integrated quantities", False):
            return []
        flux = " + ".join(f"n[{c}]*grad(e)[{c}]" for c in "xyz"[:dim])
        return [("e", "thermal vol total e", "volume"),
                ("e", "thermal bnd total e", "boundary"),
                (f"({flux})", "thermal bnd heat flux", "boundary")]

    def kernel_coefficients(self):
        """The functions behind each coefficient of the generated
        module-set kernel (functions/codegen.py, scalar_density.cuh
        thermal_density)."""
        return {"kind": "thermal", "rho": "density", "cp": "specific heat",
                "f": "thermal source", "kappa": "thermal diffusion",
                "b": _VELOCITY[:self.dim] if self.have_advection else ()}

    def qp_coefficients(self, q):
        """(S, kappa) at quadrature points, with S = rho cp u_t - f (the
        advection term left out) and flux kappa grad u: what the fused
        kernels consume (ops/fused_p1.py)."""
        sval = q.f("density") * q.f("specific heat") * q.sol_dot("e") \
            - q.f("thermal source")
        return sval, q.f("thermal diffusion")

    def qp_mass(self, q):
        """The mass coefficient rho cp at quadrature points: d S / d u_t,
        what the fused thermal kernels weight u_dot's lane with."""
        return q.f("density") * q.f("specific heat")

    def qp_velocity(self, q):
        """The advection velocity's `dim` components at quadrature
        points, or None without advection."""
        if not self.have_advection:
            return None
        return [q.f(n) for n in _VELOCITY[:self.dim]]

    def qp_density(self, q):
        """Per-qp (source, flux) densities — the same weak form as
        volume_residual, in the JAX package's qp_density form."""
        sval, kap = self.qp_coefficients(q)
        g = q.grad("e")
        for d, b in enumerate(self.qp_velocity(q) or ()):
            sval = sval + b * g[d]
        return {"e": (sval, [kap * g[d] for d in range(self.dim)])}
