"""Field contexts: expression evaluation on every element, or at points.

The port of the JAX package's `mrhyde_tpu/postprocess/fields.py`, used
by objectives, responses, extra cell fields and sensors (the reference
PostprocessManager's updateWorkset + FunctionManager evaluation at "ip"
and "point" locations). Leaves resolve to tensors on the state's device,
so an objective built from them stays a torch expression of (u, pvec).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["GlobalFieldContext", "PointFieldContext", "locate_points"]

_AX = {"x": 0, "y": 1, "z": 2}


def _t(a, like, owner=None):
    """a as a tensor of `like`'s device (and dtype, for floats). With an
    owner (the discretization whose table `a` is) the copy is kept on
    it, one per (table, device, dtype)."""
    if isinstance(a, torch.Tensor):
        if a.is_floating_point():
            return a.to(dtype=like.dtype, device=like.device)
        return a.to(device=like.device)
    key = None
    if owner is not None:
        cache = owner.__dict__.setdefault("_torch_tables", {})
        key = (id(a), like.device, like.dtype)
        if key in cache:
            return cache[key]
    a = np.asarray(a)
    out = torch.as_tensor(a, device=like.device) \
        if np.issubdtype(a.dtype, np.integer) else \
        torch.as_tensor(a, dtype=like.dtype, device=like.device)
    if key is not None:
        cache[key] = out
    return out


class GlobalFieldContext:
    """Resolve expression leaves as (E, Q) tensors from a global u."""

    def __init__(self, disc, u, time=0.0, params=None, u_dot=None,
                 field_params=None):
        self.disc = disc
        self.u = u
        self.u_dot = u_dot
        self.time = time
        self.params = params or {}
        self.field_params = field_params or {}
        self._u_e = disc.dofmap.fold(u[_t(disc.lids, u, disc)])
        self._cache = {}

    def _var(self, var):
        key = ("sol", var)
        if key not in self._cache:
            st, nd = self.disc.offsets[var]
            phi = _t(self.disc.basis_vals[self.disc.basis_keys[var]],
                     self.u, self.disc)
            self._cache[key] = self._u_e[:, st:st + nd] @ phi
        return self._cache[key]

    def _grad(self, var, ax):
        key = ("grad", var)
        if key not in self._cache:
            st, nd = self.disc.offsets[var]
            dphi = _t(self.disc.basis_grads[self.disc.basis_keys[var]],
                      self.u, self.disc)
            self._cache[key] = torch.einsum(
                "ei,eiqd->eqd", self._u_e[:, st:st + nd], dphi)
        return self._cache[key][:, :, ax]

    def _field(self, var):
        fp = self.field_params[var]
        return _t(self.params[var], self.u)[
            _t(fp["eldofs"], self.u)]

    def resolve(self, leaf):
        disc = self.disc
        if leaf in _AX and _AX[leaf] < disc.mesh.dim:
            return _t(disc.ip, self.u, disc)[:, :, _AX[leaf]]
        if leaf == "t":
            return self.time
        if leaf in disc.offsets:
            return self._var(leaf)
        if leaf.startswith("grad(") and leaf.endswith("]"):
            var = leaf[5:leaf.index(")")]
            if var in self.field_params and var in self.params:
                g = torch.einsum("ei,eiqd->eqd", self._field(var),
                                 _t(self.field_params[var]["gphi"], self.u))
                return g[..., _AX[leaf[-2]]]
            return self._grad(var, _AX[leaf[-2]])
        if leaf.endswith("_t") and leaf[:-2] in disc.offsets:
            if self.u_dot is None:
                return torch.zeros_like(self._var(leaf[:-2]))
            # the JAX package raises here too (ROADMAP, faults in the
            # JAX package)
            raise NotImplementedError("u_dot fields in responses")
        if leaf in self.field_params and leaf in self.params:
            return torch.einsum("ei,iq->eq", self._field(leaf),
                                _t(self.field_params[leaf]["phi"], self.u))
        if leaf in self.params:
            return self.params[leaf]
        raise KeyError(f"cannot resolve leaf {leaf!r} in volume response")


class PointFieldContext:
    """Resolve expression leaves at isolated points (sensors).

    elem_ids: (P,) owning elements; ref_pts: (P, dim) reference coords.
    The basis tables at each point are built once with numpy.
    """

    def __init__(self, disc, elem_ids, ref_pts, pts, u, time=0.0,
                 params=None, field_params=None):
        from mrhyde_tpu_torch.fem.basis import get_basis
        from mrhyde_tpu_torch.fem.geometry import (physical_grad,
                                                   volume_geometry)
        self.field_params = field_params or {}
        self.disc = disc
        self.time = time
        self.params = params or {}
        self.elem_ids = np.asarray(elem_ids)
        P = self.elem_ids.shape[0]
        coords = disc.coords[self.elem_ids]         # (P, nc, dim)
        self._phi = {}
        self._dphi = {}
        keys = set(disc.basis_keys.values())
        keys |= {fp["key"] for fp in self.field_params.values()
                 if "key" in fp}
        for key in keys:
            b = get_basis(disc.mesh.cell_type, key[0], key[1])
            phi = np.zeros((P, b.ndof))
            dphi = np.zeros((P, b.ndof, disc.mesh.dim))
            for p in range(P):
                pt = np.asarray(ref_pts[p])[None, :]
                geo = volume_geometry(coords[p:p + 1], disc.mesh.cell_type,
                                      pt, np.ones(1))
                phi[p] = b.eval(pt)[:, 0]
                dphi[p] = physical_grad(b, pt, geo.jac_inv)[0, :, 0, :]
            self._phi[key] = _t(phi, u)
            self._dphi[key] = _t(dphi, u)
        self._pts = _t(np.atleast_2d(pts), u)
        self.u = u
        self._eids = torch.as_tensor(self.elem_ids, device=u.device)
        self._u_e = u[_t(disc.lids[self.elem_ids], u)]   # (P, nd_total)

    def _field(self, var):
        fp = self.field_params[var]
        return _t(self.params[var], self.u)[
            _t(fp["eldofs"], self.u)[self._eids]]       # (P, ndp)

    def resolve(self, leaf):
        disc = self.disc
        if leaf in _AX and _AX[leaf] < disc.mesh.dim:
            return self._pts[:, _AX[leaf]]
        if leaf == "t":
            return self.time
        if leaf in disc.offsets:
            st, nd = disc.offsets[leaf]
            return torch.einsum("pi,pi->p", self._u_e[:, st:st + nd],
                                self._phi[disc.basis_keys[leaf]])
        if leaf in self.field_params and leaf in self.params:
            return torch.einsum("pi,pi->p", self._field(leaf),
                                self._phi[self.field_params[leaf]["key"]])
        if leaf.startswith("grad(") and leaf.endswith("]"):
            var = leaf[5:leaf.index(")")]
            ax = _AX[leaf[-2]]
            if var in self.field_params and var in self.params:
                return torch.einsum(
                    "pi,pi->p", self._field(var),
                    self._dphi[self.field_params[var]["key"]][:, :, ax])
            st, nd = disc.offsets[var]
            return torch.einsum("pi,pi->p", self._u_e[:, st:st + nd],
                                self._dphi[disc.basis_keys[var]][:, :, ax])
        if leaf in self.params:
            return self.params[leaf]
        raise KeyError(f"cannot resolve leaf {leaf!r} at sensor points")


def locate_points(mesh, pts: np.ndarray):
    """Locate points in a mesh: (elem_ids (P,), ref_coords (P, dim)).

    Structured box meshes (with box_info) by index arithmetic, any other
    by `_locate_points_general`. A structured tet mesh raises, as in the
    JAX package."""
    info = getattr(mesh, "box_info", None)
    if info is None:
        return _locate_points_general(mesh, pts)
    pts = np.atleast_2d(np.asarray(pts, dtype=float))
    dim = mesh.dim
    cells = []
    locs = []
    for d in range(dim):
        lo, hi, n = info["bounds"][d]
        h = (hi - lo) / n
        c = np.clip(((pts[:, d] - lo) // h).astype(int), 0, n - 1)
        cells.append(c)
        locs.append((pts[:, d] - (lo + c * h)) / h)   # in [0, 1]
    if mesh.cell_type == "line":
        eid = cells[0]
        ref = np.stack([2 * locs[0] - 1], axis=1)
    elif mesh.cell_type == "quad":
        ny = info["bounds"][1][2]
        eid = cells[0] * ny + cells[1]
        ref = np.stack([2 * locs[0] - 1, 2 * locs[1] - 1], axis=1)
    elif mesh.cell_type == "hex":
        ny, nz = info["bounds"][1][2], info["bounds"][2][2]
        eid = (cells[0] * ny + cells[1]) * nz + cells[2]
        ref = np.stack([2 * lc - 1 for lc in locs], axis=1)
    elif mesh.cell_type == "tri":
        ny = info["bounds"][1][2]
        quad = cells[0] * ny + cells[1]
        u, v = locs[0], locs[1]
        # T0 = (n0, n1, n2) covers v <= u; T1 = (n0, n2, n3) covers v > u
        in_t0 = v <= u
        eid = 2 * quad + np.where(in_t0, 0, 1)
        ref = np.where(in_t0[:, None], np.stack([u - v, v], axis=1),
                       np.stack([u, v - u], axis=1))
    else:
        raise NotImplementedError(f"point location in {mesh.cell_type}")
    return eid.astype(np.int64), ref


def _locate_points_general(mesh, pts, n_candidates=8):
    """Unstructured point location (Exodus meshes): candidate elements
    by nearest centroid, then Newton inversion of the isoparametric map
    with a containment check (the reference's checkInclusionPhysicalData
    / mapPointsToReference pairing, discretizationInterface.cpp)."""
    from mrhyde_tpu_torch.fem.basis import get_basis
    pts = np.atleast_2d(np.asarray(pts, dtype=float))
    dim = mesh.dim
    b = get_basis(mesh.cell_type, "HGRAD", 1)
    coords = mesh.nodes[mesh.conn]                   # (E, nc, dim)
    cents = coords.mean(axis=1)
    simplex = mesh.cell_type in ("tri", "tet")
    tol = 1e-8
    eid = np.zeros(pts.shape[0], dtype=np.int64)
    ref = np.zeros((pts.shape[0], dim))
    d2 = ((pts[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)[:, :min(n_candidates, cents.shape[0])]

    def invert(e, x):
        xi = np.full(dim, 1.0 / 3.0) if simplex else np.zeros(dim)
        for _ in range(20):
            phi = b.eval(xi[None, :])[:, 0]          # (nc,)
            dphi = b.grad(xi[None, :])[:, 0, :]      # (nc, dim)
            r = coords[e].T @ phi - x
            J = coords[e].T @ dphi
            xi = xi - np.linalg.solve(J, r)
        return xi

    for p in range(pts.shape[0]):
        best, best_viol = None, np.inf
        for e in order[p]:
            xi = invert(e, pts[p])
            if simplex:
                viol = max(np.max(-xi), np.sum(xi) - 1.0)
            else:
                viol = np.max(np.abs(xi)) - 1.0
            if viol < best_viol:
                best, best_viol = (e, xi), viol
            if viol <= tol:
                break
        eid[p], ref[p] = best[0], best[1]
    return eid, ref
