"""Assembler: residuals and Jacobians over batched elements.

The port of `mrhyde_tpu/assembly/assembler.py`:

- gather:    u_elem = u_global[lids] (slices on structured grids)
- seed:      u_eval = alpha_u*u_stage + beta_u,
             u_dot  = alpha_t*u_stage + beta_t
- residual:  pure per-element function, torch.func.vmap'd
- Jacobian:  torch.func.vmap(torch.func.jacfwd(...)) on the general
             path; the fused provider (ops/fused_p1.py) on the hot path
- scatter:   fixed-fan-in gather + sum through the incidence table
             (deterministic; no atomics, no index_add_)

Dirichlet rows use symmetric elimination: residual rows masked, unit
diagonal in operators. Boundary integrals (Neumann, Flux, weak
Dirichlet, ...) run over the boundary groups, torch.func.vmap'd per
side: the modules' `boundary_residual` and the physics-agnostic Flux
term; they are additive, so `res_and_jac` attaches them to the fused
providers' volume result as the JAX package does (`BlockJacobian.bnd`).

Vector bases (HDIV, HCURL) carry oriented dofs: the gather folds the
global coefficients into each element's local frame, u_loc = W g, with
W the dof signs plus, for tet HCURL of order >= 2, a 2x2 mixing of each
face-dof pair (`_fold_W`); residuals scatter through W^T and Jacobian
blocks become W^T J W (`_fold_WT`, `_fold_jac_WT_W`). Modules that
define `face_residual` (and decks with `assemble face terms`) get the
per-side face loop inside the same vmapped element residual; HFACE and
broken-HDIV variables read the per-side face tables of the element's
geometry bundle.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.discretization import Discretization
from mrhyde_tpu_torch.assembly.workset import Workset
from mrhyde_tpu_torch.utils.profiling import timed

__all__ = ["Assembler", "TimeCoeffs", "BlockJacobian", "PointContext",
           "build_incidence"]

_VECTOR_KEYS = ("HDIV", "HCURL")
_FACE_SPACES = ("HFACE", "HDIV-DG", "HDIV_AC-DG")


@dataclass
class TimeCoeffs:
    """Stage-solution seeding coefficients.

    u_eval = alpha_u * u_stage + beta_u (vector)
    u_dot  = alpha_t * u_stage + beta_t (vector)
    """
    alpha_u: float
    beta_u: torch.Tensor
    alpha_t: float
    beta_t: torch.Tensor
    time: float
    deltat: float
    is_steady: bool = False

    @staticmethod
    def steady(n_dof, time=0.0, dtype=torch.float64, device="cpu"):
        z = torch.zeros(n_dof, dtype=dtype, device=device)
        return TimeCoeffs(1.0, z, 0.0, z, float(time), 1.0, is_steady=True)


@dataclass
class BlockJacobian:
    """Element-block Jacobian consumed matrix-free (or densified).

    Never a global sparse matrix: per-element dense blocks + index
    arrays. Assembly sums go through the dof -> (element, local dof)
    incidence table as a fixed-fan-in gather + sum.
    """
    vol: torch.Tensor | None          # (E, nd, nd) AoS (or None)
    vol_lids: torch.Tensor            # (E, nd)
    fixed: torch.Tensor               # (n_dof,) bool
    inc: torch.Tensor                 # (n_dof, max_deg) into E*nd (+pad)
    # Row layout straight off the fused kernel: a LIST of nd*nd entries,
    # each None (structural zero), a 0-d tensor (element-independent) or
    # an (E,) tensor. diag reads it as it is; apply too while no row
    # varies by element, and through AoS blocks built on the first
    # product otherwise (see _vol_mv).
    vol_soa: list | None = None
    # additive boundary-group blocks: (B, nd, nd) per group, with the
    # group's lids (B, nd) and its BoundaryScatter
    bnd: list = field(default_factory=list)
    bnd_lids: list = field(default_factory=list)
    bnd_scatter: list = field(default_factory=list)
    # whether some SoA row holds one value per element: fixed when the
    # Jacobian is built, so the Krylov products do not rescan the rows
    soa_varies: bool = field(init=False, default=False)
    _aos_cache: torch.Tensor | None = field(default=None, repr=False)

    def __post_init__(self):
        self.soa_varies = self.vol_soa is not None and any(
            r is not None and r.dim() > 0 for r in self.vol_soa)

    @property
    def n_dof(self):
        return self.fixed.shape[0]

    @property
    def _soa_only(self):
        return self.vol is None and self.vol_soa is not None

    @property
    def _n_elem(self):
        return self.vol_lids.shape[0]

    def _soa_dtype(self):
        for r in self.vol_soa:
            if r is not None:
                return r.dtype
        raise ValueError("SoA Jacobian without any row")

    def aos(self):
        """(E, nd, nd) volume blocks, materializing constant/zero rows
        from SoA once per Jacobian where needed (the products of varying
        rows, the preconditioners' element blocks, dense)."""
        if self.vol is not None:
            return self.vol
        if self._aos_cache is None:
            nd = self.vol_lids.shape[1]
            E = self._n_elem
            dt = self._soa_dtype()
            dev = self.vol_lids.device
            rows = torch.stack([
                torch.zeros(E, dtype=dt, device=dev) if r is None
                else torch.broadcast_to(r, (E,)) for r in self.vol_soa])
            self._aos_cache = rows.T.reshape(-1, nd, nd)
        return self._aos_cache

    def _soa_mv(self, vm):
        """(E, nd) element products sum_j J[e,i,j]*vm[lids[e,j]] from
        the SoA rows."""
        nd = self.vol_lids.shape[1]
        return self.soa_products([vm[self.vol_lids[:, j]]
                                  for j in range(nd)])

    def soa_products(self, xg):
        """(E, nd) products of the SoA rows with the gathered element
        columns xg[j] (E,); None rows skip their chain, scalar rows fold
        into the multiply."""
        nd = len(xg)
        out = []
        for i in range(nd):
            terms = [self.vol_soa[i * nd + j] * xg[j]
                     for j in range(nd)
                     if self.vol_soa[i * nd + j] is not None]
            out.append(sum(terms) if terms else torch.zeros_like(xg[0]))
        return torch.stack(out, dim=1)

    def _vol_mv(self, vm):
        # Eager torch launches one op per SoA term: where a row holds one
        # value per element the AoS einsum reads the same bytes in a few
        # launches (2x faster at nd = 4, 9x at nd = 12 on the H100);
        # constant rows read no per-element data, and their SoA product
        # stays 2x faster at nd = 4, but its nd^2 launches lose from nd =
        # 8 on (AoS 1.26x faster at hex nd = 8, 6.2x at p2 nd = 9:
        # PERF.md).
        if self._soa_only:
            if not self.soa_varies and self.vol_lids.shape[1] <= 4:
                return self._soa_mv(vm)
            return torch.einsum("eij,ej->ei", self.aos(),
                                vm[self.vol_lids])
        return torch.einsum("eij,ej->ei", self.vol, vm[self.vol_lids])

    def _gather_sum(self, vals):
        """Assemble flattened per-element values -> (n_dof,)."""
        flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
        return flat[self.inc].sum(dim=1)

    def _bnd_parts(self):
        return zip(self.bnd, self.bnd_lids, self.bnd_scatter)

    def apply(self, v):
        """J @ v with Dirichlet identity rows."""
        vm = torch.where(self.fixed, 0.0, v)
        out = self._gather_sum(self._vol_mv(vm))
        for blocks, lids, sc in self._bnd_parts():
            out = sc.add(out, torch.einsum("eij,ej->ei", blocks, vm[lids]))
        return torch.where(self.fixed, v, out)

    def _apply_raw(self, v):
        """The assembled operator times v, Dirichlet rows and columns
        untouched."""
        out = self._gather_sum(self._vol_mv(v))
        for blocks, lids, sc in self._bnd_parts():
            out = sc.add(out, torch.einsum("eij,ej->ei", blocks, v[lids]))
        return out

    def transposed(self):
        """The BlockJacobian of the element blocks transposed: SoA entry
        (i, j) reads entry (j, i), AoS and boundary blocks swap their
        axes. Its `apply` is the transpose of this one's (identity
        Dirichlet rows and columns), so a Krylov solver and any
        preconditioner built from it serve a transposed solve."""
        nd = self.vol_lids.shape[1]
        soa = None if self.vol_soa is None else [
            self.vol_soa[j * nd + i] for i in range(nd) for j in range(nd)]
        return BlockJacobian(
            vol=None if self.vol is None else self.vol.transpose(1, 2),
            vol_lids=self.vol_lids, fixed=self.fixed, inc=self.inc,
            vol_soa=soa, bnd=[b.transpose(1, 2) for b in self.bnd],
            bnd_lids=list(self.bnd_lids), bnd_scatter=list(self.bnd_scatter))

    def apply_rowfix(self, v):
        """A v with A = identity Dirichlet ROWS but live columns: the
        adjoint-consistent operator (a free row keeps its dependence on
        the fixed dofs; see analysis/adjoint.py)."""
        return torch.where(self.fixed, v, self._apply_raw(v))

    def apply_rowfix_T(self, v):
        """A^T v for the row-fixed operator above."""
        vm = torch.where(self.fixed, 0.0, v)
        return self.transposed()._apply_raw(vm) + torch.where(self.fixed, v,
                                                              0.0)

    def dense_rowfix(self):
        """Dense A with identity Dirichlet rows and live columns (the JAX
        package's `_dense_rowfix`; `dense` also zeroes the columns, the
        symmetric elimination of the forward solve). Accumulated with
        index_put, so it stays differentiable in the blocks."""
        n = self.n_dof
        vol = self.aos()
        A = torch.zeros((n, n), dtype=vol.dtype, device=vol.device)
        parts = [(vol, self.vol_lids)] + list(zip(self.bnd, self.bnd_lids))
        for blocks, lids in parts:
            k = lids.shape[1]
            A = A.index_put((lids[:, :, None].expand(-1, k, k),
                             lids[:, None, :].expand(-1, k, k)), blocks,
                            accumulate=True)
        A = torch.where(self.fixed[:, None], 0.0, A)
        return A + torch.diag(self.fixed.to(A.dtype))

    def diag(self):
        if self._soa_only:
            nd = self.vol_lids.shape[1]
            E = self._n_elem
            dt = self._soa_dtype()
            dev = self.vol_lids.device
            dblk = torch.stack([
                torch.zeros(E, dtype=dt, device=dev)
                if self.vol_soa[i * nd + i] is None
                else torch.broadcast_to(self.vol_soa[i * nd + i], (E,))
                for i in range(nd)], dim=1)
        else:
            dblk = torch.diagonal(self.vol, dim1=1, dim2=2)
        d = self._gather_sum(dblk)
        for blocks, _lids, sc in self._bnd_parts():
            d = sc.add(d, torch.diagonal(blocks, dim1=1, dim2=2))
        return torch.where(self.fixed, 1.0, d)

    def dense(self):
        n = self.n_dof
        vol = self.aos()
        nd = self.vol_lids.shape[1]
        rows = [self.vol_lids[:, :, None].expand(-1, nd, nd).reshape(-1)]
        cols = [self.vol_lids[:, None, :].expand(-1, nd, nd).reshape(-1)]
        vals = [vol.reshape(-1)]
        for blocks, lids, _sc in self._bnd_parts():
            k = lids.shape[1]
            rows.append(lids[:, :, None].expand(-1, k, k).reshape(-1))
            cols.append(lids[:, None, :].expand(-1, k, k).reshape(-1))
            vals.append(blocks.reshape(-1))
        # coalesce sums duplicate (row, col) entries by sorting, not by
        # atomics, so the dense matrix is the same on every run
        with torch.sparse.check_sparse_tensor_invariants(True):
            A = torch.sparse_coo_tensor(
                torch.stack([torch.cat(rows), torch.cat(cols)]),
                torch.cat(vals), (n, n)).coalesce().to_dense()
        mask = self.fixed[:, None] | self.fixed[None, :]
        A = torch.where(mask, 0.0, A)
        A = A + torch.diag(self.fixed.to(A.dtype))
        # patch EMPTY ROWS (dofs no module touches)
        empty = torch.abs(A).sum(dim=1) == 0
        return A + torch.diag(empty.to(A.dtype))


class BoundaryScatter:
    """Deterministic scatter-add of a boundary group's per-side values
    (B, nd) onto the dofs: the group's distinct dofs and their incidence
    table into the flattened values (no atomics, no index_add_)."""

    def __init__(self, lids: np.ndarray, device):
        lids = np.asarray(lids)
        dofs, local = np.unique(lids.ravel(), return_inverse=True)
        self.dofs = torch.as_tensor(dofs, device=device)
        self.inc = torch.as_tensor(
            build_incidence(local.reshape(lids.shape), dofs.size),
            device=device)

    def add(self, out, vals):
        """out (n_dof,) with vals (B, nd) summed onto the group's dofs."""
        flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
        out = out.clone()
        out[self.dofs] += flat[self.inc].sum(dim=1)
        return out


def _fold_W(g, signs, mixp, mixw):
    """Gather-side orientation fold u_loc = W g per element (E, nd):
    diagonal signs plus the optional 2x2 face-pair mixing channel (tet
    HCURL order >= 2; mixp None: pure signs)."""
    out = g * signs
    if mixp is not None:
        out = out + mixw * torch.take_along_dim(g, mixp, dim=1)
    return out


def _fold_WT(r, signs, mixp, mixwT):
    """Scatter-side fold W^T r (signs are their own transpose; the
    mixing channel uses mixwT[j] = mixw[pair[j]])."""
    out = r * signs
    if mixp is not None:
        out = out + mixwT * torch.take_along_dim(r, mixp, dim=1)
    return out


def _fold_jac_WT_W(J, signs, mixp, mixwT):
    """Element-block Jacobian fold W^T J W (E, nd, nd): rows and columns
    from the element's local frame to the global canonical frame."""
    A = J * signs[:, :, None]
    if mixp is not None:
        A = A + mixwT[:, :, None] * torch.take_along_dim(
            J, mixp[:, :, None].expand(J.shape), dim=1)
    B = A * signs[:, None, :]
    if mixp is not None:
        B = B + mixwT[:, None, :] * torch.take_along_dim(
            A, mixp[:, None, :].expand(A.shape), dim=2)
    return B


def build_incidence(lids: np.ndarray, n_dof: int) -> np.ndarray:
    """dof -> positions in lids.ravel() (padded with E*nd = zero slot).

    Turns assembly scatter into a fixed-fan-in gather + sum."""
    flat = np.asarray(lids).ravel()
    order = np.argsort(flat, kind="stable")
    sorted_ids = flat[order]
    counts = np.bincount(sorted_ids, minlength=n_dof)
    max_deg = int(counts.max()) if counts.size else 1
    inc = np.full((n_dof, max_deg), flat.size, dtype=np.int64)
    starts = np.zeros(n_dof + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    for k in range(max_deg):
        has = counts > k
        inc[has, k] = order[starts[:-1][has] + k]
    return inc


class PointContext:
    """Expression-leaf resolver at bare points (no solution fields).

    Used for true solutions and Dirichlet data.
    """

    def __init__(self, pts, time=0.0, params=None):
        self.pts = pts
        self.time = time
        self.params = params or {}

    def resolve(self, leaf):
        ax = {"x": 0, "y": 1, "z": 2}.get(leaf)
        if ax is not None and ax < self.pts.shape[-1]:
            return self.pts[..., ax]
        if leaf == "t":
            return self.time
        if leaf in self.params:
            return self.params[leaf]
        raise KeyError(f"cannot resolve leaf {leaf!r} at points")


class Assembler:
    """Owns the volume and boundary element kernels for one block."""

    def __init__(self, disc: Discretization, modules, fm, params=None,
                 fixed_dofs=None, dtype=torch.float64, device="cpu",
                 assemble_face_terms=None):
        self.disc = disc
        self.modules = modules
        self.fm = fm
        self.params = params or {}
        self.dtype = dtype
        self.device = torch.device(device)
        dt, dev = dtype, self.device

        self.lids = torch.as_tensor(disc.lids, device=dev)
        self.n_dof = disc.n_dof
        self.inc = torch.as_tensor(build_incidence(disc.lids, disc.n_dof),
                                   device=dev)
        self._structured = self._build_structured_index(disc)

        fixed = np.zeros(disc.n_dof, dtype=bool)
        if fixed_dofs is not None and len(fixed_dofs):
            fixed[np.asarray(fixed_dofs)] = True
        self.fixed = torch.as_tensor(fixed, device=dev)

        # modules overriding face_residual get the per-side face loop
        # inside the same vmapped element residual (the reference's
        # 'assemble face terms' per-side sweep, assemblyManager.cpp:
        # 2414-2425); the deck key overrides the default
        from mrhyde_tpu_torch.physics.base import PhysicsModule
        self.face_modules = [
            m for m in modules
            if type(m).face_residual is not PhysicsModule.face_residual]
        self.assemble_face_terms = bool(self.face_modules) \
            if assemble_face_terms is None else bool(assemble_face_terms)
        needs_faces = self.assemble_face_terms or any(
            k[0] in _FACE_SPACES for k in disc.basis_keys.values())

        # Basis-database compression: on affine-uniform meshes every
        # element shares ONE geometry, so quadrature weights and the
        # physical basis tables are stored once and broadcast (vmap
        # in_dims None). rtol 1e-9: linspace node rounding accumulates
        # ~1e-13 relative deviations at NX=512.
        wts0 = disc.wts[0]
        self.uniform = bool(
            np.allclose(disc.wts, wts0[None, :], rtol=1e-9, atol=1e-12)
            and all(np.allclose(v, v[0][None], rtol=1e-9, atol=1e-9)
                    for d in (disc.basis_grads, disc.vec_vals,
                              disc.div_vals, disc.curl_vals)
                    for v in d.values()))
        if needs_faces and self.uniform:
            self.uniform = all(
                np.allclose(v, v[0][None]) for v in
                [disc.face_wts_all, disc.face_normals_all]
                + list(disc.face_vec_all.values()))
        self.g_wts = torch.as_tensor(wts0 if self.uniform else disc.wts,
                                     dtype=dt, device=dev)
        self.g_bg = self._geometry_bundle(needs_faces)
        self._geo_ax = None if self.uniform else 0
        # orientation: u_loc = signs*g + mixw*g[mixp]; the scatter and
        # Jacobian folds use the transposed weight mixwT[j] = mixw[pair[j]]
        dm = disc.dofmap
        self.signs = torch.as_tensor(dm.signs, dtype=dt, device=dev)
        self.mixp = self.mixw = self.mixwT = None
        if dm.mix_pair is not None:
            self.mixp = torch.as_tensor(dm.mix_pair, dtype=torch.int64,
                                        device=dev)
            self.mixw = torch.as_tensor(dm.mix_w, dtype=dt, device=dev)
            self.mixwT = torch.take_along_dim(self.mixw, self.mixp, dim=1)
        self.has_signs = bool(np.any(dm.signs != 1.0)) \
            or self.mixp is not None
        self.g_ip = torch.as_tensor(disc.ip, dtype=dt, device=dev)
        self.g_bv = {k: torch.as_tensor(v, dtype=dt, device=dev)
                     for k, v in disc.basis_vals.items()}
        self._bnd = [self._boundary_group(bg)
                     for bg in disc.boundary_groups]
        # var -> {sideset -> condition type}, set by the Problem
        self.var_bcs: dict[str, dict[str, str]] = {}
        self._fused = None
        self._fused_built = False
        # set by the Problem for 'solver: transient' decks
        self.is_transient = False
        # static per-element data from mesh data files (reference
        # importMeshData: element centers take the value of the closest
        # data point), name -> (E, ...), read by the physics as the
        # workset's extra fields (crystal elasticity's rotated "crystal_C")
        self.extra_elem_fields: dict = {}
        # per-block physics masks (E, n_modules), or None (one physics
        # list for every block)
        self.module_masks = None
        # discretized (field) parameters, name -> {"eldofs" (E, ndp),
        # "phi" (ndp, Q), "gphi" (E, ndp, Q, dim), "key", "dof_coords",
        # "n_dof", "value" (the dof vector a call without it in pvec
        # reads)}, set by the Problem (reference parameterManager.cpp:
        # 272 setupDiscretizedParameters)
        self.field_params: dict = {}
        # the leaves that arrive as per-qp '__field:<leaf>' entries of
        # pvec (a multi-set deck's other sets' variables), set by
        # MultiSetProblem; the fused providers read them as coefficients
        # that vary by element
        self.field_leaves: set = set()
        # the multiscale subgrid model (multiscale/subgrid.py), set by the
        # Problem for a deck with a Subgrid sublist; its upscaled flux
        # REPLACES the macro volume terms (reference: a multiscale group
        # skips them, assemblyManager; JAX assembler.py:508-512)
        self.multiscale = None
        self.volume_off = False

    @property
    def general_only(self):
        """Whether the deck takes the general path whatever its modules:
        oriented dofs (signs or a mixing channel), face terms, an HFACE /
        broken-HDIV variable, a discretized parameter or a multiscale
        model. The fused providers' `build` returns None for it, as the
        JAX package's FusedP1Assembly.build does
        (`mrhyde_tpu/ops/fused_p1.py:217-219` and its face check)."""
        return self.has_signs or self.assemble_face_terms \
            or bool(self.face_modules) or bool(self.field_params) \
            or self.multiscale is not None or any(
                k[0] in _FACE_SPACES for k in self.disc.basis_keys.values())

    def _geometry_bundle(self, needs_faces):
        """The element geometry tables the volume workset reads, one
        element's (uniform meshes) or every element's: basis gradients,
        the oriented vector tables ("vec", "div", "curl"), and with face
        terms or face spaces the per-side weights, normals, vector and
        scalar face tables and the HFACE trace tables."""
        disc = self.disc
        E = disc.mesh.n_elem

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=self.dtype,
                                   device=self.device)

        def per_elem(a):
            return t(a[0] if self.uniform else a)

        def shared(a):
            # element-independent tables ride the same vmap axis
            return t(a if self.uniform else np.broadcast_to(
                a, (E,) + np.shape(a)))
        out = {name: {k: per_elem(v) for k, v in tbl.items()}
               for name, tbl in (("grad", disc.basis_grads),
                                 ("vec", disc.vec_vals),
                                 ("div", disc.div_vals),
                                 ("curl", disc.curl_vals))}
        if not needs_faces:
            return out
        out["fwts"] = per_elem(disc.face_wts_all)
        out["fnorm"] = per_elem(disc.face_normals_all)
        out["fvec"] = {k: per_elem(v) for k, v in disc.face_vec_all.items()}
        out["fscal"] = {k: shared(v) for k, v in disc.face_scal_all.items()}
        # HFACE trace basis at side qps: element-independent (the flips
        # are folded into the dof numbering)
        hkeys = [k for k in set(disc.basis_keys.values())
                 if k[0] == "HFACE" and k[1] >= 1]
        if hkeys:
            from mrhyde_tpu_torch.fem.vector_basis import (hface_face_vals,
                                                           hface_side_vals)
            out["hface"] = {
                k: shared(hface_side_vals(k[1], disc.side_pts[:, 0])
                          if disc.mesh.dim == 2 else
                          hface_face_vals(disc.mesh.cell_type, k[1],
                                          disc.side_pts))
                for k in hkeys}
        return out

    def _boundary_group(self, bg):
        """A boundary group's side data as tensors on the device: the
        vector face tables are per element (Piola), sliced to the group's
        elements, as are the orientation signs and mixing weights."""
        dt, dev = self.dtype, self.device
        dm = self.disc.dofmap

        def t(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)
        mixp = mixw = mixwT = None
        if dm.mix_pair is not None:
            mixp = torch.as_tensor(dm.mix_pair[bg.elems], dtype=torch.int64,
                                   device=dev)
            mixw = t(dm.mix_w[bg.elems])
            mixwT = torch.take_along_dim(mixw, mixp, dim=1)
        return {"sideset": bg.sideset, "side": bg.side,
                "elems": torch.as_tensor(bg.elems, device=dev),
                "lids": torch.as_tensor(bg.lids, device=dev),
                "scatter": BoundaryScatter(bg.lids, dev),
                "signs": t(dm.signs[bg.elems]), "mixp": mixp, "mixw": mixw,
                "mixwT": mixwT,
                "wts": t(bg.wts), "ip": t(bg.ip), "normals": t(bg.normals),
                "bv": {k: t(v) for k, v in bg.basis_vals.items()
                       if k[0] not in _VECTOR_KEYS},
                "bg": {"grad": {k: t(v) for k, v in bg.basis_grads.items()},
                       "vec": {k: t(np.asarray(v)[bg.elems])
                               for k, v in bg.basis_vals.items()
                               if k[0] in _VECTOR_KEYS}}}

    # ------------------------------------------------------------------
    # structured-mesh fast path: on uniform box meshes with nodal p1
    # variables, gather and scatter are pure slice/pad ops
    # ------------------------------------------------------------------

    def _build_structured_index(self, disc):
        mesh = disc.mesh
        info = getattr(mesh, "box_info", None)
        if info is None or mesh.cell_type not in ("quad", "hex", "line") \
                or getattr(mesh, "periodic", False):
            return None
        dims = [b[2] for b in info["bounds"]]
        corners = {
            "line": [(0,), (1,)],
            "quad": [(0, 0), (1, 0), (1, 1), (0, 1)],
            "hex": [(0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0),
                    (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1)],
        }[mesh.cell_type]
        plan = []
        for i, (name, _s, _o) in enumerate(disc.variables):
            key = disc.basis_keys[name]
            start = int(disc.dofmap.var_start[i])
            if key == ("HGRAD", 1):
                plan.append(("p1", name, start))
            elif key == ("HGRAD", 2) and mesh.cell_type == "quad":
                # the p2 fine lattice: read only by the fused provider
                # (ops/fused_p1.py); the general gather/scatter below
                # stays p1 (see "general")
                plan.append(("p2", name, start))
            else:
                return None
        return {"dims": dims, "corners": corners, "plan": plan,
                "grid": [d + 1 for d in dims],
                "general": all(k == "p1" for (k, _n, _st) in plan)}

    @property
    def _slices(self):
        """Whether the general path gathers and scatters by grid slices
        (an all-p1 structured plan) rather than through lids."""
        return self._structured is not None and self._structured["general"]

    def _gather_structured(self, u):
        s = self._structured
        dims, grid, corners = s["dims"], s["grid"], s["corners"]
        E = int(np.prod(dims))
        cols = []
        for _kind, _name, start in s["plan"]:
            g = u[start:start + int(np.prod(grid))].reshape(grid)
            for c in corners:
                sl = tuple(slice(c[d], c[d] + dims[d])
                           for d in range(len(dims)))
                cols.append(g[sl].reshape(E))
        return torch.stack(cols, dim=1)

    def _scatter_structured(self, vals):
        s = self._structured
        dims, grid, corners = s["dims"], s["grid"], s["corners"]
        parts = []
        col = 0
        for _kind, _name, _start in s["plan"]:
            # pad+sum: one padded add per corner
            acc = None
            for c in corners:
                part = pad_to(vals[:, col].reshape(dims), c, grid)
                acc = part if acc is None else acc + part
                col += 1
            parts.append(acc.reshape(-1))
        return torch.cat(parts)

    # ------------------------------------------------------------------
    # element kernels
    # ------------------------------------------------------------------

    def set_module_masks(self, masks):
        """Per-block physics (reference physicsInterface.cpp:38-54):
        masks is (E, n_modules), 1 where module k owns the element's
        block. Each module's volume and boundary contribution is scaled
        by its mask, over one batched element array."""
        self.module_masks = torch.as_tensor(np.asarray(masks),
                                            dtype=self.dtype,
                                            device=self.device)

    def _elem_residual(self, u_st, beta_u, beta_t, wts, ip, bg, extra=None,
                       *, alpha_u, alpha_t, time, params, deltat=1.0):
        return self._elem_residual_uv(alpha_u * u_st + beta_u,
                                      alpha_t * u_st + beta_t, wts, ip, bg,
                                      time, params, deltat, extra)

    def _elem_residual_uv(self, u_eval, u_dot, wts, ip, bg, time, params,
                          deltat=1.0, extra=None):
        bm = None
        if extra is not None and "__blockmask" in extra:
            extra = dict(extra)
            bm = extra.pop("__blockmask")
        wk = self._workset(wts, ip, self.g_bv, bg, u_eval, u_dot, time,
                           params, deltat, extra_fields=extra)
        if not self.volume_off:
            _masked_modules(wk, self.modules, bm, self._volume_terms)
        return wk.res

    def _volume_terms(self, m, wk):
        """Module m's element terms: its volume residual, and its face
        residual where the deck assembles face terms."""
        m.volume_residual(wk)
        if self.assemble_face_terms and m in self.face_modules:
            m.face_residual(wk)

    def _workset(self, wts, ip, bv, bg, u_eval, u_dot, time, params,
                 deltat, **side):
        """A Workset over one element's (or side's) tables: bg is the
        geometry bundle (basis gradients, vector tables and, on volume
        worksets with face terms, the per-side tables)."""
        return Workset(
            dim=self.disc.mesh.dim, wts=wts, ip=ip, basis_vals=bv,
            basis_grads=bg["grad"], basis_vecs=bg.get("vec"),
            basis_divs=bg.get("div"), basis_curls=bg.get("curl"),
            face_wts=bg.get("fwts"), face_normals=bg.get("fnorm"),
            face_vecs=bg.get("fvec"), face_scals=bg.get("fscal"),
            hface_vals=bg.get("hface"), offsets=self.disc.offsets,
            var_keys=self.disc.basis_keys, u_eval=u_eval, u_dot=u_dot,
            time=time, fm=self.fm, params=params, deltat=deltat,
            is_transient=self.is_transient, **side)

    def _field_value(self, name, pvec):
        """The dof vector of a discretized parameter: pvec's, else the
        registry's value (on the assembler's device and dtype)."""
        v = (pvec or {}).get(name, self.field_params[name]["value"])
        return torch.as_tensor(v, dtype=self.dtype, device=self.device)

    def _elem_extra(self, pvec=None):
        """The per-element fields the volume worksets read (the JAX
        package's `_field_param_values`): the discretized parameters and
        their gradients at the qps, the block masks (under
        "__blockmask"), the mesh-data fields, and last pvec's
        '__field:<leaf>' (E, Q) entries (a multi-set deck's other sets,
        a UQ sample's regenerated grains), which override a static
        field of the same name; None without any."""
        out = {}
        axes = "xyz"[:self.disc.mesh.dim]
        for name, fp in self.field_params.items():
            pe = self._field_value(name, pvec)[fp["eldofs"]]   # (E, ndp)
            out[name] = torch.einsum("ei,iq->eq", pe, fp["phi"])
            g = torch.einsum("ei,eiqd->eqd", pe, fp["gphi"])
            for ax, c in enumerate(axes):
                out[f"grad({name})[{c}]"] = g[..., ax]
        if self.module_masks is not None:
            out["__blockmask"] = self.module_masks
        out.update(self.extra_elem_fields)
        for name, val in (pvec or {}).items():
            if str(name).startswith("__field:"):
                out[name[8:]] = val
        return out or None

    def _bnd_extra(self, group, pvec=None):
        """The discretized parameters and their gradients at a boundary
        group's side qps, (B, Qf) (the JAX package's
        `_field_param_boundary_values`); None without any."""
        out = {}
        axes = "xyz"[:self.disc.mesh.dim]
        for name, fp in self.field_params.items():
            phi = group["bv"].get(fp["key"])
            if phi is None:
                raise NotImplementedError(
                    f"no face basis table for field param {name!r} "
                    f"({fp['key']}) on sideset {group['sideset']!r}")
            pe = self._field_value(name, pvec)[fp["eldofs"][group["elems"]]]
            out[name] = torch.einsum("bi,iq->bq", pe, phi)
            gph = group["bg"]["grad"].get(fp["key"])
            if gph is not None:
                g = torch.einsum("bi,biqd->bqd", pe, gph)
                for ax, c in enumerate(axes):
                    out[f"grad({name})[{c}]"] = g[..., ax]
        return out or None

    def _params(self, pvec):
        """The expression-leaf parameters of a call: the deck's, updated
        by pvec, without the discretized parameters and '__field:'
        entries (they reach the worksets as per-qp extra fields), and
        without a multiscale model's fine state ('__ms')."""
        params = dict(self.params)
        params.update(pvec or {})
        params.pop("__ms", None)
        for name in self.field_params:
            params.pop(name, None)
        for k in [k for k in params if str(k).startswith("__field:")]:
            params.pop(k)
        return params

    def _elem_fn(self, tc: TimeCoeffs, pvec):
        params = self._params(pvec)

        def fn(u_st, beta_u, beta_t, wts, ip, bg, extra):
            return self._elem_residual(
                u_st, beta_u, beta_t, wts, ip, bg, extra,
                alpha_u=tc.alpha_u, alpha_t=tc.alpha_t, time=tc.time,
                params=params, deltat=tc.deltat)
        return fn

    def _in_dims(self, extra):
        return (0, 0, 0, self._geo_ax, 0, self._geo_ax,
                None if extra is None else 0)

    def _orientation(self, group=None):
        """(signs, mixp, mixw, mixwT) of the elements, or of a boundary
        group's elements."""
        o = self.__dict__ if group is None else group
        return o["signs"], o["mixp"], o["mixw"], o["mixwT"]

    def _gathered(self, u_st, tc: TimeCoeffs, group=None):
        """The element (or a boundary group's side) coefficients of u_st,
        beta_u and beta_t, folded into the local frames of oriented
        dofs."""
        if group is None and self._slices:
            return (self._gather_structured(u_st),
                    self._gather_structured(tc.beta_u),
                    self._gather_structured(tc.beta_t))
        lids = self.lids if group is None else group["lids"]
        vals = (u_st[lids], tc.beta_u[lids], tc.beta_t[lids])
        if not self.has_signs:
            return vals
        signs, mixp, mixw, _ = self._orientation(group)
        return tuple(_fold_W(v, signs, mixp, mixw) for v in vals)

    def _fold_res(self, res_e, group=None):
        """W^T of element (or side) residuals; as they are without
        oriented dofs."""
        if not self.has_signs:
            return res_e
        signs, mixp, _, mixwT = self._orientation(group)
        return _fold_WT(res_e, signs, mixp, mixwT)

    def _fold_jac(self, jac_e, group=None):
        """W^T J W of element (or side) Jacobian blocks."""
        if not self.has_signs:
            return jac_e
        signs, mixp, _, mixwT = self._orientation(group)
        return _fold_jac_WT_W(jac_e, signs, mixp, mixwT)

    def residual(self, u_st, tc: TimeCoeffs, pvec=None):
        """Global residual (n_dof,) with Dirichlet rows zeroed."""
        r = self._residual_free(u_st, tc, pvec)
        if self.multiscale is not None:
            r = r + self.multiscale.residual_contribution(u_st, tc, pvec)
        return torch.where(self.fixed, 0.0, r)

    def _residual_free(self, u_st, tc: TimeCoeffs, pvec=None):
        """The volume and boundary-group residual (n_dof,), Dirichlet
        rows as they are."""
        u_e, bu_e, bt_e = self._gathered(u_st, tc)
        extra = self._elem_extra(pvec)
        res_e = torch.func.vmap(self._elem_fn(tc, pvec),
                                in_dims=self._in_dims(extra))(
            u_e, bu_e, bt_e, self.g_wts, self.g_ip, self.g_bg, extra)
        res_e = self._fold_res(res_e)
        if self._slices:
            r = self._scatter_structured(res_e)
        else:
            flat = torch.cat([res_e.reshape(-1), res_e.new_zeros(1)])
            r = flat[self.inc].sum(dim=1)
        if self._active_bnd_groups():
            r = r + self._bnd_res_scatter(u_st, tc, pvec)
        return r

    def jacobian(self, u_st, tc: TimeCoeffs, pvec=None) -> BlockJacobian:
        """Element-block Jacobian d(residual)/d(u_stage), general path."""
        J = self._jacobian_general(u_st, tc, pvec)
        if self.multiscale is None:
            return J
        return _with_blocks(J, self.multiscale.jacobian_blocks(u_st, tc,
                                                               pvec))

    def _jacobian_general(self, u_st, tc: TimeCoeffs, pvec=None):
        u_e, bu_e, bt_e = self._gathered(u_st, tc)
        extra = self._elem_extra(pvec)
        jac_e = torch.func.vmap(
            torch.func.jacfwd(self._elem_fn(tc, pvec), argnums=0),
            in_dims=self._in_dims(extra))(
            u_e, bu_e, bt_e, self.g_wts, self.g_ip, self.g_bg, extra)
        return BlockJacobian(vol=self._fold_jac(jac_e), vol_lids=self.lids,
                             fixed=self.fixed, inc=self.inc,
                             **self._bnd_jac_parts(u_st, tc, pvec))

    # ------------------------------------------------------------------
    # boundary groups (JAX assembler.py `_belem_residual`,
    # `_bnd_res_scatter`, `_bnd_jac_parts`, `_active_bnd_groups`)
    # ------------------------------------------------------------------

    def _active_bnd_groups(self):
        """Boundary groups with at least one condition to integrate:
        every type but strong Dirichlet, and the Dirichlet data of a
        variable without trace dofs (a natural boundary integral)."""
        from mrhyde_tpu_torch.solvers.bcs import broken_space
        out = []
        for g in self._bnd:
            for v in self.disc.var_names:
                bct = self.var_bcs.get(v, {}).get(g["sideset"])
                if bct in ("Neumann", "weak Dirichlet", "Robin", "Far-field",
                           "Slip", "Flux"):
                    out.append(g)
                    break
                if bct == "Dirichlet":
                    vdm = self.disc.dofmap.var(v)
                    if broken_space(getattr(vdm.basis, "space", "")) \
                            or not any(vdm.basis.side_dofs(s) for s in
                                       range(self.disc.topo.n_side)):
                        out.append(g)
                        break
        return out

    def _belem_residual(self, group, u_st, beta_u, beta_t, wts, ip,
                        normals, bg, bmask=None, bex=None, *, alpha_u,
                        alpha_t, time, params, deltat):
        """One side's residual (ndof_total,): the modules'
        boundary_residual, each masked to its own blocks' elements under
        per-block physics, and the physics-agnostic Flux conditions
        (reference physicsInterface.cpp fluxConditions: res += -(g, v)
        for any module)."""
        ss = group["sideset"]
        bcs = {v: self.var_bcs.get(v, {}).get(ss)
               for v in self.disc.var_names}
        wk = self._workset(wts, ip, group["bv"], bg, alpha_u * u_st + beta_u,
                           alpha_t * u_st + beta_t, time, params, deltat,
                           normals=normals, side_name=ss, bcs=bcs,
                           extra_fields=bex)
        _masked_modules(wk, self.modules, bmask,
                        lambda m, w: m.boundary_residual(w))
        for v in self.disc.var_names:
            if bcs.get(v) == "Flux":
                g = wk.f(f"Flux {v} {ss}", "side ip")
                wk.add_source(v, -wk.qp(g))
        return wk.res

    def _bnd_fn(self, group, tc: TimeCoeffs, pvec):
        params = self._params(pvec)

        def fn(u_st, beta_u, beta_t, wts, ip, normals, bg, bmask, bex):
            return self._belem_residual(
                group, u_st, beta_u, beta_t, wts, ip, normals, bg, bmask,
                bex, alpha_u=tc.alpha_u, alpha_t=tc.alpha_t, time=tc.time,
                params=params, deltat=tc.deltat)
        return fn

    def _bnd_args(self, group, u_st, tc: TimeCoeffs, pvec=None):
        bmask = None if self.module_masks is None \
            else self.module_masks[group["elems"]]
        return (*self._gathered(u_st, tc, group), group["wts"],
                group["ip"], group["normals"], group["bg"], bmask,
                self._bnd_extra(group, pvec))

    def _bnd_in_dims(self):
        return (0,) * 7 + (None if self.module_masks is None else 0,
                           0 if self.field_params else None)

    def _bnd_res_scatter(self, u_st, tc: TimeCoeffs, pvec=None):
        """The summed boundary-group residual (n_dof,): additive to the
        volume residual, so the fused providers compose with it."""
        r = torch.zeros(self.n_dof, dtype=u_st.dtype, device=u_st.device)
        for group in self._active_bnd_groups():
            res_b = torch.func.vmap(self._bnd_fn(group, tc, pvec),
                                    in_dims=self._bnd_in_dims())(
                *self._bnd_args(group, u_st, tc, pvec))
            r = group["scatter"].add(r, self._fold_res(res_b, group))
        return r

    def _bnd_jac_parts(self, u_st, tc: TimeCoeffs, pvec=None):
        """{bnd, bnd_lids, bnd_scatter} of the active boundary groups:
        each group's (B, nd, nd) side Jacobians, additive to the volume
        blocks."""
        parts = {"bnd": [], "bnd_lids": [], "bnd_scatter": []}
        for group in self._active_bnd_groups():
            parts["bnd"].append(self._fold_jac(torch.func.vmap(
                torch.func.jacfwd(self._bnd_fn(group, tc, pvec), argnums=0),
                in_dims=self._bnd_in_dims())(
                *self._bnd_args(group, u_st, tc, pvec)), group))
            parts["bnd_lids"].append(group["lids"])
            parts["bnd_scatter"].append(group["scatter"])
        return parts

    def set_field_leaves(self, leaves):
        """Name the leaves that arrive as per-qp '__field:<leaf>' pvec
        entries (MultiSetProblem: the other sets' variables); the fused
        provider is built again at its next use, reading them as
        coefficients that vary by element."""
        self.field_leaves = set(leaves)
        self._fused, self._fused_built = None, False

    def fused_provider(self):
        """The fused provider (ops/fused_p1.py), built on
        first use, or None when the problem does not qualify. It engages
        on every device: on the CPU its wrappers run the plain versions
        of the kernels, on the card the CUDA kernels."""
        if not self._fused_built:
            from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
            self._fused = FusedP1Assembly.build(self)
            self._fused_built = True
        return self._fused

    @timed("assembly")
    def res_and_jac(self, u_st, tc: TimeCoeffs, pvec=None):
        """(residual, BlockJacobian) in one pass — the Newton-loop entry
        point. Uses the fused provider when the problem qualifies
        (uniform structured meshes: thermal, with or without advection,
        and cdr on 2D p1 quads, 3D p1 hex and 2D p2 quads; Navier-Stokes
        on 2D p1 quads) and the params are scalars (or a multi-set deck's
        '__field:' entries of the leaves in `field_leaves`), steady or
        transient alike, else the general vmapped path. Active boundary groups
        (Neumann, Flux, weak Dirichlet, ...) are additive: their residual
        and blocks from the general path join the fused result, as the
        JAX package attaches them. A multiscale deck adds its upscaled
        residual and macro blocks from one pass of the fine solves."""
        if self.multiscale is not None:
            r_ms, blocks = self.multiscale.residual_and_blocks(u_st, tc,
                                                               pvec)
            r = self._residual_free(u_st, tc, pvec) + r_ms
            return (torch.where(self.fixed, 0.0, r),
                    _with_blocks(self._jacobian_general(u_st, tc, pvec),
                                 blocks))
        fused = self.fused_provider()
        if fused is not None and all(
                not isinstance(v, torch.Tensor) or v.dim() == 0
                or (str(k).startswith("__field:")
                    and k[8:] in self.field_leaves)
                for k, v in (pvec or {}).items()):
            r, J = fused.jacobian(u_st, tc, pvec)
            if self._active_bnd_groups():
                r = torch.where(self.fixed, 0.0,
                                r + self._bnd_res_scatter(u_st, tc, pvec))
                J = replace(J, **self._bnd_jac_parts(u_st, tc, pvec))
            return r, J
        return (self.residual(u_st, tc, pvec),
                self.jacobian(u_st, tc, pvec))

    def matfree_apply_fn(self, J):
        """v -> J v through the structured slice gather/scatter (a
        drop-in replacement for BlockJacobian.apply)."""
        if not self._slices:
            return J.apply

        def apply(v):
            vm = torch.where(J.fixed, 0.0, v)
            ve = self._gather_structured(vm)
            if J._soa_only:
                prods = J.soa_products([ve[:, j]
                                        for j in range(ve.shape[1])])
            else:
                prods = torch.einsum("eij,ej->ei", J.vol, ve)
            out = self._scatter_structured(prods)
            for blocks, lids, sc in J._bnd_parts():
                out = sc.add(out, torch.einsum("eij,ej->ei", blocks,
                                               vm[lids]))
            return torch.where(J.fixed, v, out)
        return apply

    # ------------------------------------------------------------------
    # mass / projections
    # ------------------------------------------------------------------

    def mass_jacobian(self) -> BlockJacobian:
        """Block mass matrix of all variables as a BlockJacobian (no
        Dirichlet rows)."""
        M = torch.as_tensor(self.disc.mass_blocks(), dtype=self.dtype,
                            device=self.device)
        return BlockJacobian(vol=self._fold_jac(M), vol_lids=self.lids,
                             inc=self.inc,
                             fixed=torch.zeros(self.n_dof, dtype=torch.bool,
                                               device=self.device))

    def weighted_mass_blocks(self, u_st, tc: TimeCoeffs, pvec=None):
        """Physics-weighted mass blocks M = d(residual)/d(u_dot), (E, nd,
        nd): the jacfwd of the element residual in its time-derivative
        argument, so rho*cp-style weights come along."""
        u_e, bu_e, bt_e = self._gathered(u_st, tc)
        params = self._params(pvec)

        def fn(udot_e, ueval_e, wts, ip, bg):
            return self._elem_residual_uv(ueval_e, udot_e, wts, ip, bg,
                                          tc.time, params, tc.deltat)

        return self._fold_jac(torch.func.vmap(
            torch.func.jacfwd(fn, argnums=0),
            in_dims=(0, 0, self._geo_ax, 0, self._geo_ax))(
            tc.alpha_t * u_e + bt_e, tc.alpha_u * u_e + bu_e, self.g_wts,
            self.g_ip, self.g_bg))

    def lumped_mass(self, u_st, tc: TimeCoeffs, pvec=None):
        """Row-sum lumped weighted mass vector (n_dof,)."""
        rows = self.weighted_mass_blocks(u_st, tc, pvec).sum(dim=2)
        flat = torch.cat([rows.reshape(-1), rows.new_zeros(1)])
        d = flat[self.inc].sum(dim=1)
        return torch.where(self.fixed, 1.0, torch.where(d == 0, 1.0, d))

    def l2_rhs(self, exprs: dict, time=0.0):
        """RHS of the global L2 projection, b_i = sum_q f(x_q) phi_i w_q.
        exprs: var -> expression (missing vars get 0); a vector variable
        takes component expressions 'E[x]', 'E[y]'..., through its
        oriented vector table (folded by W^T); an HFACE variable the
        facet integral over every element side (which pairs with the
        facet mass of Discretization.mass_blocks)."""
        disc = self.disc
        dt, dev = self.dtype, self.device
        ctx = PointContext(self.g_ip, time=time, params=self.params)
        wtsE = torch.as_tensor(disc.wts, dtype=dt, device=dev)   # (E, Q)
        contrib = torch.zeros(self.lids.shape, dtype=dt, device=dev)

        def values(expr, c, shape):
            return torch.broadcast_to(torch.as_tensor(
                self.fm.evaluate_expr(expr, c), dtype=dt, device=dev),
                shape)
        for var in disc.var_names:
            key = disc.basis_keys[var]
            st, nd = disc.offsets[var]
            if key[0] in _VECTOR_KEYS:
                comps = {ax: exprs[f"{var}[{lbl}]"]
                         for ax, lbl in enumerate("xyz"[:disc.mesh.dim])
                         if f"{var}[{lbl}]" in exprs}
                if not comps:
                    continue
                f = torch.zeros(wtsE.shape + (disc.mesh.dim,), dtype=dt,
                                device=dev)
                for ax, expr in comps.items():
                    f[:, :, ax] = values(expr, ctx, wtsE.shape)
                vv = torch.as_tensor(disc.vec_vals[key], dtype=dt,
                                     device=dev)
                c = torch.einsum("eiqd,eqd->ei", vv, f * wtsE[:, :, None])
                if self.has_signs:
                    mp = None if self.mixp is None \
                        else self.mixp[:, st:st + nd] - st
                    mwT = None if self.mixwT is None \
                        else self.mixwT[:, st:st + nd]
                    c = _fold_WT(c, self.signs[:, st:st + nd], mp, mwT)
                contrib[:, st:st + nd] += c
                continue
            if var not in exprs:
                continue
            if key[0] == "HFACE":
                for s, fg in enumerate(disc.faces):
                    psi = torch.as_tensor(disc.face_basis_vals[s][key],
                                          dtype=dt, device=dev)  # (nd, Qf)
                    fw = torch.as_tensor(fg.wts, dtype=dt, device=dev)
                    ctxf = PointContext(torch.as_tensor(
                        fg.ip, dtype=dt, device=dev), time=time,
                        params=self.params)
                    contrib[:, st:st + nd] += torch.einsum(
                        "iq,eq->ei", psi,
                        values(exprs[var], ctxf, fw.shape) * fw)
                continue
            contrib[:, st:st + nd] += torch.einsum(
                "iq,eq->ei", self.g_bv[key],
                values(exprs[var], ctx, wtsE.shape) * wtsE)
        flat = torch.cat([contrib.reshape(-1), contrib.new_zeros(1)])
        return flat[self.inc].sum(dim=1)


def _with_blocks(J, blocks):
    """J with more additive element blocks: (blocks, lids, scatter)
    triples (a multiscale model's macro blocks)."""
    return replace(J, bnd=J.bnd + [b for b, _l, _s in blocks],
                   bnd_lids=J.bnd_lids + [lids for _b, lids, _s in blocks],
                   bnd_scatter=J.bnd_scatter + [s for _b, _l, s in blocks])


def _masked_modules(wk, modules, bm, terms):
    """Runs terms(m, wk) for each module m; with per-block masks bm
    (n_modules,), module k's contribution is kept on its own blocks
    only, accumulated in module order as the JAX package does: res =
    prev + bm[k] (res - prev)."""
    if bm is None:
        for m in modules:
            terms(m, wk)
        return
    prev = wk.res
    for k, m in enumerate(modules):
        terms(m, wk)
        wk.set_res(prev + bm[k] * (wk.res - prev))
        prev = wk.res


def pad_to(a, offset, shape):
    """Zero-pad `a` so that it sits at `offset` inside `shape`."""
    pad = []
    for o, d, g in reversed(list(zip(offset, a.shape, shape))):
        pad += [o, g - d - o]
    return torch.nn.functional.pad(a, pad)
