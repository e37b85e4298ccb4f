"""Hybridized/stabilized shallow water equations.

The port of the JAX package's `mrhyde_tpu/physics/shallowwater_hybridized.py`
(reference shallowwaterHybridized.cpp): HGRAD variables H, Hux [, Huy]
in conservation form,
  (H_t, w) - (Hu, grad w)
  (Hu_t, w) - (Hu x Hu / H + g H^2 / 2 I, grad w),
with Far-field and Slip boundary fluxes built from the eigendecomposition
of the normal flux Jacobian (`swe_flux_jacobian_eig`; the CG collapse of
the HDG trace form gives F_hat.n = F(S).n + A-(S)(S_inf - S)). No fused
kernel: the general path.
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.ops.sparse_dual import abs_
from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["ShallowWaterHybridized", "swe_flux_jacobian_eig"]


def _flux_n(S, n, gravity):
    """The SWE normal flux F(S).n, (Q, 1 + dim), of states S (Q, 1 +
    dim) along normals n (Q, dim)."""
    h = S[:, 0]
    mom = S[:, 1:]
    un = ((mom / h[:, None]) * n).sum(dim=1)
    return torch.cat([(mom * n).sum(dim=1)[:, None],
                      mom * un[:, None] + 0.5 * gravity * (h * h)[:, None]
                      * n], dim=1)


def _eig(S, n, gravity):
    """(lambda (Q, 1 + dim), R (Q, 1 + dim, 1 + dim)) of dF_n/dS: the
    eigenvalues (u.n - a, u.n ..., u.n + a) and the right eigenvectors
    as the columns of R."""
    dim = n.shape[1]
    h = S[:, 0]
    vel = S[:, 1:] / h[:, None]
    un = (vel * n).sum(dim=1)
    a = torch.sqrt(gravity * h)
    lam = torch.cat([(un - a)[:, None], un[:, None].expand(-1, dim - 1),
                     (un + a)[:, None]], dim=1)
    one = torch.ones_like(h)[:, None]
    cols = [torch.cat([one, vel - a[:, None] * n], dim=1)]
    if dim == 2:
        cols.append(torch.cat([torch.zeros_like(one),
                               torch.stack([-n[:, 1], n[:, 0]], dim=1)],
                              dim=1))
    cols.append(torch.cat([one, vel + a[:, None] * n], dim=1))
    return lam, torch.stack(cols, dim=2)


def swe_flux_jacobian_eig(H, hu, n, gravity=9.8):
    """(dF_n/dS, its eigenvalues) at one state (H, hu (dim,)) along the
    unit normal n (dim,), float64 on the CPU (reference
    shallowwaterHybridized eigendecompFluxJacobian)."""
    S = torch.cat([torch.atleast_1d(torch.as_tensor(H, dtype=torch.float64)),
                   torch.as_tensor(hu, dtype=torch.float64)])
    nn = torch.as_tensor(n, dtype=torch.float64)[None, :]
    A = torch.func.jacfwd(lambda s: _flux_n(s[None], nn, gravity)[0])(S)
    lam, _ = _eig(S[None], nn, gravity)
    return A.numpy(), lam[0].numpy()


@register("shallow water hybridized")
class ShallowWaterHybridized(PhysicsModule):
    name = "shallowwaterHybridized"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        self.gravity = float(self.settings.get("gravity", 9.8))

    def variables(self):
        out = [("H", "HGRAD", 1), ("Hux", "HGRAD", 1)]
        if self.dim > 1:
            out.append(("Huy", "HGRAD", 1))
        return out

    def define_functions(self, fm, fs):
        for v in ("H", "Hux", "Huy"):
            fm.add_function(f"source {v}",
                            self._f(fs, f"source {v}", 0.0), "ip")

    def volume_residual(self, wk):
        g = self.gravity
        dim = self.dim
        H = wk.sol("H")
        mom = [wk.sol(m) for m in ["Hux", "Huy"][:dim]]
        wk.add_source("H", wk.sol_dot("H") - wk.qp(wk.f("source H")))
        wk.add_flux("H", -torch.stack(mom, dim=1))
        pres = 0.5 * g * H * H
        for d, name in enumerate(["Hux", "Huy"][:dim]):
            F = torch.stack([mom[d] * mom[j] / H + (pres if j == d else 0.0)
                             for j in range(dim)], dim=1)
            wk.add_source(name, wk.sol_dot(name)
                          - wk.qp(wk.f(f"source {name}")))
            wk.add_flux(name, -F)

    def boundary_residual(self, wk):
        """Far-field and Slip boundary fluxes (reference
        shallowwaterHybridized.cpp computeBoundaryTerm)."""
        bct = wk.bcs.get("H") or wk.bcs.get("Hux")
        if bct not in ("Far-field", "Slip"):
            return
        g = self.gravity
        dim = self.dim
        names = ["H"] + ["Hux", "Huy"][:dim]
        S = torch.stack([wk.sol(v) for v in names], dim=1)  # (Qf, nv)
        n = wk.normals
        if bct == "Slip":
            H = S[:, 0]
            for d, name in enumerate(names[1:]):
                wk.add_source(name, 0.5 * g * H * H * n[:, d])
            return
        Sinf = torch.stack([wk.qp(wk.f(f"Far-field {v} {wk.side_name}",
                                       "side ip")) for v in names], dim=1)
        lam, R = _eig(S, n, g)
        lam_m = 0.5 * (lam - abs_(lam))
        L = torch.linalg.inv(R)
        tot = _flux_n(S, n, g) + torch.einsum(
            "qij,qj->qi", R, lam_m * torch.einsum("qij,qj->qi", L, Sinf - S))
        for i, v in enumerate(names):
            wk.add_source(v, tot[:, i])
