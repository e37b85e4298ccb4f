"""Burgers equation physics module.

The port of the JAX package's `mrhyde_tpu/physics/burgers.py` (reference
burgers.cpp:53-160): du/dt + div(1/2 v u^2 - eps grad u) = source, i.e.
(u_t - source, w) + (eps grad u - v u^2/2, grad w), with the optional
entropy viscosity ('entropy viscosity') and SUPG ('use SUPG') of the
reference. No fused kernel: the general path, as in the JAX package.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.ops.sparse_dual import abs_
from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["Burgers"]

_VELOCITY = ("xvel", "yvel", "zvel")


@register("Burgers")
class Burgers(PhysicsModule):
    name = "burgers"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.use_evisc = bool(self.settings.get("entropy viscosity", False))
        self.use_supg = bool(self.settings.get("use SUPG", False))

    def variables(self):
        return [("u", "HGRAD", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("Burgers source",
                        self._f(fs, "Burgers source", 0.0), "ip")
        fm.add_function("diffusion", self._f(fs, "diffusion", 0.0), "ip")
        for v in _VELOCITY:
            fm.add_function(v, self._f(fs, v, 1.0), "ip")
            fm.add_function(v, self._f(fs, v, 1.0), "side ip")
        if self.use_evisc:
            fm.add_function("C1", self._f(fs, "C1", 0.0), "ip")
            fm.add_function("C2", self._f(fs, "C2", 1.0), "ip")
        if self.use_supg:
            fm.add_function("supg C", self._f(fs, "supg C", 0.0), "ip")
            fm.add_function("supg C1", self._f(fs, "supg C1", 1.0), "ip")
            fm.add_function("supg C2", self._f(fs, "supg C2", 1.0), "ip")

    def volume_residual(self, wk):
        source = wk.f("Burgers source")
        eps = wk.qp(wk.f("diffusion"))
        u = wk.sol("u")
        u_t = wk.sol_dot("u")
        gradu = wk.grad("u")
        usq = 0.5 * u * u
        vel = [wk.qp(wk.f(v)) for v in _VELOCITY[:self.dim]]

        evisc = 0.0
        if self.use_evisc:
            c1 = wk.qp(wk.f("C1"))
            c2 = wk.qp(wk.f("C2"))
            h = wk.h
            entres = u * (u_t + u * gradu.sum(dim=1))
            ev = c1 * h * h * abs_(1e-12 + entres) / c2
            # torch.minimum splits a tie's tangent in halves, as jnp's
            evisc = torch.minimum(ev, torch.full_like(ev, 0.1))

        wk.add_source("u", u_t - source)
        flux = (eps + evisc)[:, None] * gradu \
            - torch.stack(vel, dim=1) * usq[:, None]
        if self.use_supg:
            cs = wk.qp(wk.f("supg C"))
            c1 = wk.qp(wk.f("supg C1"))
            c2 = wk.qp(wk.f("supg C2"))
            nvel = sum(v * v for v in vel)
            # the root only where it is differentiable, as the reference
            nvel = torch.where(nvel > 1e-12, torch.sqrt(nvel), nvel)
            tau = cs / (c1 / wk.deltat + c2 * nvel / wk.h)
            adv = sum(v * u * gradu[:, d] for d, v in enumerate(vel))
            sres = tau * (u_t + adv - wk.qp(source))
            flux = flux + torch.stack(vel, dim=1) * (sres * u)[:, None]
        wk.add_flux("u", flux)
