"""Mixed-form porous (Darcy) flow: HDIV velocity + HVOL pressure.

The port of the JAX package's `mrhyde_tpu/physics/porous_mixed.py`
(reference porousMixed.cpp volumeResidual / boundaryResidual):
  u-eq: (Kinv u, v) - (p, div v) + <p_D, v.n>_GammaD
  p-eq: (div u - source, q)
Dirichlet pressure data enters naturally through the boundary integral.
The inverse permeability comes from the functions Kinv_xx/yy/zz, or from
the mesh data file ('use permeability data': Kinv = 1 / data), and is
divided by exp(KL) under 'use KL expansion' (porousMixed.cpp:53-107,
:565-700: a log-permeability from the parameters 'KLUQcoeffs' and
'KLStochcoeffs' over a total-order product of per-direction KL modes).
Wells ('Wells' sublist) add their sources to the p equation. No fused
kernel: the general path, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mrhyde_tpu_torch.physics.base import PhysicsModule
from mrhyde_tpu_torch.physics.registry import register

__all__ = ["PorousMixed"]


@register("porous mixed")
class PorousMixed(PhysicsModule):
    name = "porousMixed"

    def __init__(self, settings=None, dim: int = 2):
        super().__init__(settings, dim)
        from mrhyde_tpu_torch.physics.wells import Wells
        self.wells = Wells(self.settings)
        self.use_perm_data = bool(
            self.settings.get("use permeability data", False))
        self.use_kl = bool(self.settings.get("use KL expansion", False))
        if self.use_kl:
            from mrhyde_tpu_torch.utils.klexpansion import KLExpansion
            klp = dict(self.settings.get("KL parameters", {}))
            self.kl = []
            for ax in ["x-direction", "y-direction",
                       "z-direction"][:self.dim]:
                sub = dict(klp.get(ax, {}))
                self.kl.append(KLExpansion(
                    int(sub.get("N", 1)),
                    domain_length=float(sub.get("L", 1.0)),
                    correlation_length=float(sub.get("eta", 1.0)),
                    sigma=float(sub.get("sigma", 1.0))))
            self.kl_indices = _total_order([k.N for k in self.kl])

    def _kl_log_perm(self, wk):
        """sum_k c_k sqrt(prod_d lambda) prod_d phi(x_d) at the qps, or
        None without coefficients."""
        coeffs = [torch.as_tensor(wk.params[p], dtype=wk.ip.dtype,
                                  device=wk.ip.device).reshape(-1)
                  for p in ("KLUQcoeffs", "KLStochcoeffs") if p in wk.params]
        if not coeffs:
            return None
        c = torch.cat(coeffs)
        kl = 0.0
        for k in range(min(int(c.shape[0]), self.kl_indices.shape[0])):
            term = c[k]
            for d in range(self.dim):
                i = int(self.kl_indices[k, d])
                term = term * float(np.sqrt(self.kl[d].lam[i])) \
                    * self.kl[d].eigenfunction(i, wk.ip[:, d])
            kl = kl + term
        return kl

    def variables(self):
        return [("p", "HVOL", 0), ("u", "HDIV", 1)]

    def define_functions(self, fm, fs):
        fm.add_function("source", self._f(fs, "source", 0.0), "ip")
        for k in ("Kinv_xx", "Kinv_yy", "Kinv_zz"):
            fm.add_function(k, self._f(fs, k, 1.0), "ip")
        fm.add_function("total_mobility",
                        self._f(fs, "total_mobility", 1.0), "ip")

    def volume_residual(self, wk):
        dim = self.dim
        if self.use_perm_data:
            Kinv = [wk.qp(1.0 / wk.extra_fields["mesh_data"])] * dim
        else:
            Kinv = [wk.qp(wk.f(k))
                    for k in ("Kinv_xx", "Kinv_yy", "Kinv_zz")[:dim]]
        if self.use_kl:
            kl = self._kl_log_perm(wk)
            if kl is not None:
                Kinv = [Ki / torch.exp(kl) for Ki in Kinv]
        u = wk.sol("u")                      # (Q, dim)
        p = wk.sol("p")
        wk.add_vec_source("u", torch.stack([Kinv[d] * u[:, d]
                                            for d in range(dim)], dim=1))
        wk.add_div_source("u", -p)
        src = wk.qp(wk.f("source"))
        if self.wells:
            src = self.wells.add_sources(src, wk)
        wk.add_source("p", wk.div("u") - src)

    def boundary_residual(self, wk):
        if wk.bcs.get("p") == "Dirichlet":
            pD = wk.qp(wk.f(f"Dirichlet p {wk.side_name}", "side ip"))
            wk.add_vec_source("u", pD[:, None] * wk.normals)
        elif wk.bcs.get("p") == "interface":
            # the multiscale coupling: the macro trace acts as the
            # boundary pressure (reference porousMixed.cpp:410-430,
            # res_u += <lambda, v.n>)
            lam = wk.qp(wk.resolve("aux p"))
            wk.add_vec_source("u", lam[:, None] * wk.normals)

    def compute_flux(self, wk):
        """The upscaled flux of the multiscale coupling, u.n (reference
        porousMixed.cpp:440-500 computeFlux)."""
        return {"p": (wk.sol("u") * wk.normals).sum(dim=1)}


def _total_order(nterms):
    """The reference's total-order enumeration of the KL mode products
    (porousMixed.cpp:82-107), (n, dim) mode indices."""
    dim = len(nterms)
    idx = []
    if dim == 1:
        idx = [(i,) for i in range(nterms[0])]
    elif dim == 2:
        for alpha in range(nterms[0] + nterms[1] - 1):
            for j in range(nterms[1]):
                for i in range(nterms[0]):
                    if i + j == alpha:
                        idx.append((i, j))
    else:
        for alpha in range(sum(nterms) - 2):
            for k in range(nterms[2]):
                for j in range(nterms[1]):
                    for i in range(nterms[0]):
                        if i + j + k == alpha:
                            idx.append((i, j, k))
    return np.asarray(idx, dtype=int)
