"""Boundary-condition setup: strong Dirichlet.

The strong-Dirichlet part of the JAX package's `mrhyde_tpu/solvers/
bcs.py`: the `fixed` dof mask, and the values written there — scalar
data directly, expression data by an L2 projection on the boundary
(the reference's projectDirichlet). Neumann, Robin, weak Dirichlet,
far-field, slip, flux and point conditions are not ported yet (ROADMAP
A4) and raise.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import PointContext

__all__ = ["BoundaryConditions"]

_UNPORTED_KINDS = ("Neumann conditions", "Far-field conditions",
                   "Slip conditions", "Flux conditions")


def _is_number(x):
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


@dataclass
class _DirichletEntry:
    var: str
    sideset: str
    expr: object
    dofs: np.ndarray         # global dof ids on this sideset


@dataclass
class BoundaryConditions:
    """Parsed strong-Dirichlet config for one physics set."""

    disc: object
    fm: object
    params: dict = field(default_factory=dict)
    strong: list = field(default_factory=list)       # _DirichletEntry

    @classmethod
    def from_config(cls, disc, fm, physics_cfg: dict, params=None):
        """physics_cfg: the 'Physics' sublist of the input deck."""
        for kind in _UNPORTED_KINDS:
            sub = {k: v for k, v in (physics_cfg.get(kind) or {}).items()
                   if k not in ("scalar data", "static data")}
            if sub:
                raise NotImplementedError(
                    f"{kind!r} are not ported to mrhyde_tpu_torch yet "
                    "(ROADMAP A4)")
        if bool(physics_cfg.get("use weak Dirichlet", False)):
            raise NotImplementedError(
                "weak Dirichlet conditions are not ported yet (ROADMAP A4)")
        if any(isinstance(k, str) and k.endswith("_point_DBCs")
               for k in physics_cfg):
            raise NotImplementedError(
                "point Dirichlet conditions are not ported yet "
                "(ROADMAP A4)")
        self = cls(disc=disc, fm=fm, params=params or {})
        dofmap = disc.dofmap
        mesh = dofmap.mesh
        all_sidesets = list(mesh.sidesets)
        sub = physics_cfg.get("Dirichlet conditions", {}) or {}
        for var, sides in sub.items():
            if var in ("scalar data", "static data") \
                    or var not in disc.var_names:
                # deck-wide flags, or names that are not variables (the
                # reference ignores unknown keys)
                continue
            if not isinstance(sides, dict):
                sides = {"all boundaries": sides}
            for sidename, expr in sides.items():
                names = (all_sidesets if sidename == "all boundaries"
                         else [sidename])
                for ss in names:
                    if ss not in mesh.sidesets:
                        continue
                    self.strong.append(_DirichletEntry(
                        var, ss, expr,
                        dofmap.sideset_dofs(var, mesh.sidesets[ss])))
        return self

    @property
    def fixed_dofs(self) -> np.ndarray:
        if not self.strong:
            return np.zeros(0, dtype=np.int64)
        return np.unique(np.concatenate([e.dofs for e in self.strong]))

    def dirichlet_values(self, time=0.0):
        """float64 CPU vector with g at strongly-fixed dofs, 0 elsewhere.

        Scalar entries are set directly; expression entries are
        L2-projected on the boundary (per variable)."""
        disc = self.disc
        vals = torch.zeros(disc.n_dof, dtype=torch.float64)
        by_var = {}
        for e in self.strong:
            by_var.setdefault(e.var, []).append(e)
        for var, entries in by_var.items():
            if all(_is_number(e.expr) for e in entries):
                for e in entries:
                    vals[torch.as_tensor(e.dofs)] = float(e.expr)
                continue
            fdofs = np.unique(np.concatenate([e.dofs for e in entries]))
            nfix = fdofs.shape[0]
            st, nd = disc.offsets[var]
            key = disc.basis_keys[var]
            from mrhyde_tpu_torch.fem.basis import get_basis
            basis = get_basis(disc.mesh.cell_type, key[0], key[1])
            M = torch.zeros((nfix, nfix), dtype=torch.float64)
            b = torch.zeros(nfix, dtype=torch.float64)
            for e in entries:
                for g in disc.boundary_groups:
                    if g.sideset != e.sideset:
                        continue
                    cols = basis.side_dofs(g.side)
                    if not cols:
                        continue
                    gdofs = g.lids[:, st:st + nd][:, cols]      # (B, k)
                    idx = torch.as_tensor(np.searchsorted(fdofs, gdofs))
                    phi = torch.as_tensor(g.basis_vals[key][cols])
                    w = torch.as_tensor(g.wts)                   # (B, Qf)
                    ctx = PointContext(torch.as_tensor(g.ip), time,
                                       self.params)
                    gv = torch.broadcast_to(torch.as_tensor(
                        self.fm.evaluate_expr(e.expr, ctx),
                        dtype=torch.float64), w.shape)
                    Mloc = torch.einsum("iq,jq,bq->bij", phi, phi, w)
                    bloc = torch.einsum("iq,bq->bi", phi, gv * w)
                    M.index_put_((idx[:, :, None], idx[:, None, :]), Mloc,
                                 accumulate=True)
                    b.index_put_((idx,), bloc, accumulate=True)
            vals[torch.as_tensor(fdofs)] = torch.linalg.solve(M, b)
        return vals

    def apply(self, u, time=0.0):
        """Overwrite strong-Dirichlet dofs of u with g(x, t)."""
        fixed = self.fixed_dofs
        if fixed.size == 0:
            return u
        vals = self.dirichlet_values(time).to(dtype=u.dtype,
                                              device=u.device)
        mask = torch.zeros(u.shape[0], dtype=torch.bool, device=u.device)
        mask[torch.as_tensor(fixed, device=u.device)] = True
        return torch.where(mask, vals, u)
