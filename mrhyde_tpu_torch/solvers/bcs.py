"""Boundary-condition setup: strong and weak Dirichlet, Neumann,
Far-field, Slip and Flux conditions.

The port of the JAX package's `mrhyde_tpu/solvers/bcs.py`. Per
(variable, sideset) the deck names a condition type (reference:
discretizationInterface.cpp setBCData): a strong Dirichlet condition
fixes the variable's dofs on the sideset, with the values written there
(scalar data directly, expression data by an L2 projection on the
boundary, the reference's projectDirichlet); every other type registers
its data as the function '<type> <var> <sideset>' at "side ip", which
the modules' `boundary_residual` (and the assembler's physics-agnostic
Flux term) read on the boundary groups. `use weak Dirichlet` turns each
Dirichlet entry into a 'weak Dirichlet' one. Point Dirichlet conditions,
'<var>_point_DBCs: <nodeset names>', pin the variable's nodal dofs on
those Exodus nodesets to zero (reference
discretizationInterface.cpp:2637-2672).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import PointContext

__all__ = ["BoundaryConditions"]

_KINDS = (("Dirichlet conditions", "Dirichlet"),
          ("Neumann conditions", "Neumann"),
          ("Far-field conditions", "Far-field"),
          ("Slip conditions", "Slip"),
          ("Flux conditions", "Flux"))


def _is_number(x):
    try:
        float(x)
        return True
    except (TypeError, ValueError):
        return False


def broken_space(space):
    """Whether a basis space has no trace continuity (HVOL, *-DG): its
    Dirichlet data enters as a boundary integral, not a row fix."""
    return space.endswith("-DG") or space == "HVOL"


@dataclass
class _DirichletEntry:
    var: str
    sideset: str
    expr: object
    dofs: np.ndarray         # global dof ids on this sideset


@dataclass
class BoundaryConditions:
    """Parsed boundary conditions of one physics set: the strong
    Dirichlet entries, and var -> {sideset -> condition type}."""

    disc: object
    fm: object
    params: dict = field(default_factory=dict)
    strong: list = field(default_factory=list)       # _DirichletEntry
    var_bcs: dict = field(default_factory=dict)      # var->{sideset->type}

    @classmethod
    def from_config(cls, disc, fm, physics_cfg: dict, params=None,
                    use_weak_dirichlet=False):
        """physics_cfg: the 'Physics' sublist of the input deck."""
        self = cls(disc=disc, fm=fm, params=params or {})
        dofmap = disc.dofmap
        mesh = dofmap.mesh
        all_sidesets = list(mesh.sidesets)
        for kind, bctype in _KINDS:
            sub = physics_cfg.get(kind, {}) or {}
            for var, sides in sub.items():
                if var in ("scalar data", "static data") \
                        or var not in disc.var_names:
                    # deck-wide flags, or names that are not variables
                    # (the reference ignores unknown keys)
                    continue
                if not isinstance(sides, dict):
                    sides = {"all boundaries": sides}
                for sidename, expr in sides.items():
                    names = (all_sidesets if sidename == "all boundaries"
                             else [sidename])
                    for ss in names:
                        if ss not in mesh.sidesets:
                            continue
                        self._add(var, ss, expr, bctype, use_weak_dirichlet)
        for key, names in physics_cfg.items():
            if not (isinstance(key, str) and key.endswith("_point_DBCs")):
                continue
            var = key[:-len("_point_DBCs")]
            for ns, node_ids in mesh.nodesets.items():
                # a nodeset whose name the entry's text contains, as the
                # JAX package matches them
                if ns and ns in str(names):
                    self.strong.append(_DirichletEntry(
                        var, f"point:{ns}", 0.0, dofmap.global_dofs(
                            var, np.asarray(node_ids, dtype=np.int64))))
        return self

    def _add(self, var, ss, expr, bctype, use_weak_dirichlet):
        """One (variable, sideset) condition, as the JAX package files
        it: the later of two entries for the same pair names its type."""
        dofmap = self.disc.dofmap
        eff = "weak Dirichlet" if bctype == "Dirichlet" \
            and use_weak_dirichlet else bctype
        self.var_bcs.setdefault(var, {})[ss] = eff
        if eff != "Dirichlet":
            self.fm.add_function(f"{eff} {var} {ss}", expr, "side ip")
            return
        broken = broken_space(getattr(dofmap.var(var).basis, "space", ""))
        dofs = np.zeros(0, dtype=np.int64) if broken else \
            dofmap.sideset_dofs(var, dofmap.mesh.sidesets[ss])
        if dofs.size == 0:
            # no trace dofs: the Dirichlet data enters as a natural
            # boundary integral
            self.fm.add_function(f"Dirichlet {var} {ss}", expr, "side ip")
        else:
            self.strong.append(_DirichletEntry(var, ss, expr, dofs))

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
