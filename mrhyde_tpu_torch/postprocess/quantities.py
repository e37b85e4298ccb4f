"""Integrated quantities and flux responses.

The port of the JAX package's `mrhyde_tpu/postprocess/quantities.py`
(reference PostprocessManager::addIntegratedQuantities /
computeIntegratedQuantities, postprocessManager.cpp:504; the modules'
setupIntegratedQuantities hooks; 'Flux responses', boundary integrals of
a weighted flux over named sidesets).

Each quantity is (integrand expression, name, location) with location
'volume' or 'boundary'; boundary integrands may read n[x], n[y], n[z].
"""

from __future__ import annotations

import torch

from mrhyde_tpu_torch.postprocess.fields import GlobalFieldContext, _t

__all__ = ["IntegratedQuantities", "BoundaryFieldContext", "weighted_norm"]

_AX = {"x": 0, "y": 1, "z": 2}


class BoundaryFieldContext:
    """Expression-leaf resolver on one boundary group: the solution,
    normals and coordinates at its side quadrature points."""

    def __init__(self, disc, bg, u, time=0.0, params=None):
        self.disc = disc
        self.bg = bg
        self.u = u
        self.time = time
        self.params = params or {}
        dm = disc.dofmap
        u_g = u[_t(disc.lids[bg.elems], u)]
        self._u_e = u_g * _t(dm.signs[bg.elems], u)
        if dm.mix_pair is not None:   # tet HCURL >= 2 face-pair mixing
            self._u_e = self._u_e + _t(dm.mix_w[bg.elems], u) * \
                torch.take_along_dim(u_g, _t(dm.mix_pair[bg.elems], u),
                                     dim=1)

    def resolve(self, leaf):
        disc, bg, u = self.disc, self.bg, self.u
        if leaf in _AX and _AX[leaf] < disc.mesh.dim:
            return _t(bg.ip, u)[:, :, _AX[leaf]]
        if leaf == "t":
            return self.time
        if leaf.startswith("n[") and leaf.endswith("]"):
            return _t(bg.normals, u)[:, :, _AX[leaf[2]]]
        if leaf in disc.offsets:
            st, nd = disc.offsets[leaf]
            return self._u_e[:, st:st + nd] @ _t(
                bg.basis_vals[disc.basis_keys[leaf]], u)
        if leaf.startswith("grad(") and leaf.endswith("]"):
            var = leaf[5:leaf.index(")")]
            st, nd = disc.offsets[var]
            dphi = _t(bg.basis_grads[disc.basis_keys[var]], u)
            return torch.einsum("ei,eiq->eq", self._u_e[:, st:st + nd],
                                dphi[..., _AX[leaf[-2]]])
        if leaf in self.params:
            return self.params[leaf]
        raise KeyError(f"cannot resolve {leaf!r} on boundary")


class IntegratedQuantities:
    def __init__(self, disc, fm, specs, params=None, sidesets=None):
        """specs: list of (integrand, name, location[, sideset])."""
        self.disc = disc
        self.fm = fm
        self.specs = list(specs)
        self.params = params or {}
        self.sidesets = sidesets    # optional restriction per spec

    @classmethod
    def from_problem(cls, problem, extra_config=None):
        specs = []
        for m in problem.modules:
            hook = getattr(m, "setup_integrated_quantities", None)
            if hook:
                specs.extend(hook(problem.mesh.dim))
        for name, sub in (extra_config or {}).items():
            specs.append((sub.get("integrand", "0.0"), name,
                          sub.get("location", "volume"),
                          sub.get("boundary names",
                                  sub.get("boundary name", None))))
        return cls(problem.disc, problem.fm, specs, problem.params)

    def compute(self, u, time=0.0, pvec=None) -> dict:
        params = dict(self.params)
        params.update(pvec or {})
        out = {}
        wts = _t(self.disc.wts, u, self.disc)
        for spec in self.specs:
            integrand, name, location = spec[0], spec[1], spec[2]
            restrict = spec[3] if len(spec) > 3 else None
            if location == "volume":
                ctx = GlobalFieldContext(self.disc, u, time, params)
                vals = torch.broadcast_to(torch.as_tensor(
                    self.fm.evaluate_expr(integrand, ctx), dtype=u.dtype,
                    device=u.device), wts.shape)
                out[name] = float(torch.sum(vals * wts))
            else:
                total = 0.0
                for bg in self.disc.boundary_groups:
                    if restrict and bg.sideset != restrict:
                        continue
                    ctx = BoundaryFieldContext(self.disc, bg, u, time,
                                               params)
                    w = _t(bg.wts, u)
                    vals = torch.broadcast_to(torch.as_tensor(
                        self.fm.evaluate_expr(integrand, ctx),
                        dtype=u.dtype, device=u.device), w.shape)
                    total += float(torch.sum(vals * w))
                out[name] = total
        return out


def weighted_norm(u, weights=None, atol=1e-6, rtol=1e-6):
    """TN-style weighted norm of a solution vector (reference: 'compute
    weighted norm')."""
    u = torch.as_tensor(u)
    if weights is None:
        weights = 1.0 / (atol + rtol * torch.abs(u))
    return float(torch.sqrt(torch.sum((weights * u) ** 2) / u.shape[0]))
