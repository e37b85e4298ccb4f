"""Linear elasticity physics module.

The port of the JAX package's `mrhyde_tpu/physics/linearelasticity.py`
(reference linearelasticity.cpp:90-235 and computeStress): stress sigma =
lambda tr(eps) I + 2 mu eps with eps = sym(grad d); residual_d =
(sigma_d., grad v) - (source_d, v). The thermoelastic coupling, sigma -=
alpha_T (3 lambda + 2 mu) (e - T_ambient) I, switches on when a
temperature variable 'e' shares the set. Boundary terms: the Neumann
traction -(g, v) per displacement component and the multiscale
"interface" Nitsche coupling to the macro displacement trace, whose
upscaled traction is `compute_flux` (multiscale/subgrid.py).
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["LinearElasticity"]

_DISP = ["dx", "dy", "dz"]


def _strain(wk, dim):
    """sym(grad d) at the quadrature points, (Q, dim, dim)."""
    G = torch.stack([wk.grad(d)[:, :dim] for d in _DISP[:dim]], dim=1)
    return 0.5 * (G + G.transpose(1, 2))


@register("linearelasticity")
class LinearElasticity(PhysicsModule):
    name = "linearelasticity"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.t_ambient = float(self.settings.get("T_ambient", 0.0))
        self.alpha_T = float(self.settings.get("alpha_T", 1.0e-6))

    def variables(self):
        return [(d, "HGRAD", 1) for d in _DISP[:self.dim]]

    def define_functions(self, fm, fs):
        for loc in ("ip", "side ip"):
            fm.add_function("lambda", self._f(fs, "lambda", 1.0), loc)
            fm.add_function("mu", self._f(fs, "mu", 0.5), loc)
        for d in _DISP:
            fm.add_function(f"source {d}",
                            self._f(fs, f"source {d}", 0.0), "ip")
        fm.add_function("alpha_T", self._f(fs, "alpha_T", self.alpha_T),
                        "ip")

    def _stress(self, wk, loc="ip"):
        dim = self.dim
        mu = wk.qp(wk.f("mu", loc))
        if bool(self.settings.get("incplanestress", False)):
            # incompressible plane stress: lambda = 2 mu
            # (linearelasticity.cpp:935,990,1104)
            lam = 2.0 * mu
        else:
            lam = wk.qp(wk.f("lambda", loc))
        eps = _strain(wk, dim)
        tr = eps.diagonal(dim1=1, dim2=2).sum(dim=1)
        eye = torch.eye(dim, dtype=eps.dtype, device=eps.device)
        sigma = (lam * tr)[:, None, None] * eye \
            + 2.0 * mu[:, None, None] * eps
        if "e" in wk.offsets:
            aT = wk.qp(wk.f("alpha_T"))
            sigma = sigma - (aT * (3 * lam + 2 * mu)
                             * (wk.sol("e") - self.t_ambient))[:, None,
                                                                None] * eye
        return sigma

    def volume_residual(self, wk):
        sigma = self._stress(wk)
        for d, name in enumerate(_DISP[:self.dim]):
            wk.add_flux(name, sigma[:, d, :])
            wk.add_source(name, -wk.qp(wk.f(f"source {name}")))

    def _interface(self, wk):
        """(lambda, mu, n, sigma, pen) on a side: the Lame parameters,
        normals, stress and the Nitsche penalty 'penalty' (lambda + 2
        mu) / h_side of the multiscale coupling."""
        lam = wk.qp(wk.f("lambda", "side ip"))
        mu = wk.qp(wk.f("mu", "side ip"))
        pen = (float(self.settings.get("penalty", 10.0))
               * (lam + 2.0 * mu) / wk.side_h)
        return lam, mu, wk.normals, self._stress(wk, "side ip"), pen

    def boundary_residual(self, wk):
        """The Neumann traction of each displacement component
        (reference linearelasticity.cpp:267-315: res += -g v w); on an
        "interface" side the multiscale Nitsche coupling to the macro
        displacement trace (reference linearelasticity.cpp:333-470):
        res_i += [-(sigma n)_i + pen (u - lam)_i] v - form_param tau(u -
        lam, n)_i . grad v, tau(D, n) = lambda (D.n) I + mu (D n^T + n
        D^T)."""
        names = _DISP[:self.dim]
        if any(wk.bcs.get(n) == "interface" for n in names):
            lam, mu, n, sigma, pen = self._interface(wk)
            sf = float(self.settings.get("form_param", 1.0))
            delta = torch.stack([wk.sol(v) - wk.qp(wk.resolve(f"aux {v}"))
                                 for v in names], dim=1)       # (Q, dim)
            dn = (delta * n).sum(dim=1)
            eye = torch.eye(self.dim, dtype=delta.dtype, device=delta.device)
            tau = (lam * dn)[:, None, None] * eye + mu[:, None, None] * (
                delta[:, :, None] * n[:, None, :]
                + n[:, :, None] * delta[:, None, :])          # (Q, dim, dim)
            for i, v in enumerate(names):
                wk.add_source(v, pen * delta[:, i]
                              - (sigma[:, i, :] * n).sum(dim=1))
                if sf != 0.0:
                    wk.add(v, -sf * torch.einsum(
                        "iqd,qd,q->i", wk.basis_grad(v), tau[:, i, :],
                        wk.wts))
            return
        for name in names:
            if wk.bcs.get(name) == "Neumann":
                g = wk.f(f"Neumann {name} {wk.side_name}", "side ip")
                wk.add_source(name, -wk.qp(g))

    def compute_flux(self, wk):
        """The upscaled traction of the multiscale coupling (reference
        linearelasticity.cpp:677-800 computeFlux): flux_i = (sigma n)_i +
        pen (lam - u)_i."""
        _lam, _mu, n, sigma, pen = self._interface(wk)
        return {v: (sigma[:, i, :] * n).sum(dim=1)
                + pen * (wk.qp(wk.resolve(f"aux {v}")) - wk.sol(v))
                for i, v in enumerate(_DISP[:self.dim])}
