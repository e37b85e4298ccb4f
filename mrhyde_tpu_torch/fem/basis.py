"""Reference-element basis functions.

The TPU-native replacement for the Intrepid2 basis factory the reference
wraps (reference: src/interfaces/discretizationInterface.cpp:354-430,
getBasis). Bases are evaluated at setup time with numpy into dense
(ndof, nqp[, dim]) tables that the traced compute path consumes as
constants — on TPU the tables live in VMEM and feed MXU contractions.

Supported: HGRAD (nodal Lagrange) order 1..4 on line/quad/tri/hex/tet,
HVOL (piecewise constant). HDIV/HCURL/HFACE are provided in
mrhyde_tpu_torch.fem.vector_basis.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache
from itertools import product

import numpy as np

from mrhyde_tpu_torch.fem.topology import cell_topology

__all__ = ["Basis", "get_basis"]


def _monomials(cell: str, order: int) -> list[tuple[int, ...]]:
    """Monomial exponent tuples spanning the Lagrange space."""
    dim = cell_topology(cell).dim
    if cell in ("quad", "hex", "line"):
        return list(product(range(order + 1), repeat=dim))
    # simplices: total degree
    return [e for e in product(range(order + 1), repeat=dim)
            if sum(e) <= order]


def _lagrange_nodes(cell: str, order: int) -> np.ndarray:
    """Nodal points: corners, then edge nodes, then face nodes, then interior.

    Ordering convention (ours): corner dofs in topology corner order,
    then per edge (in topology edge order) the order-1 interior edge nodes
    from the lower-numbered corner toward the higher, then face interior
    nodes, then cell interior nodes.
    """
    topo = cell_topology(cell)
    pts = [topo.corners[i] for i in range(topo.n_corner)]
    if order >= 2:
        # edge interior nodes
        for (a, b) in topo.edges:
            for k in range(1, order):
                t = k / order
                pts.append((1 - t) * topo.corners[a] + t * topo.corners[b])
        if cell == "quad":
            for i in range(1, order):
                for j in range(1, order):
                    x = -1 + 2 * i / order
                    y = -1 + 2 * j / order
                    pts.append(np.array([x, y]))
        elif cell == "hex":
            # face interior nodes (tensor grid on each face), then interior
            for f in topo.faces:
                c = topo.corners[list(f)]
                for i in range(1, order):
                    for j in range(1, order):
                        u, v = i / order, j / order
                        p = ((1 - u) * (1 - v) * c[0] + u * (1 - v) * c[1]
                             + u * v * c[2] + (1 - u) * v * c[3])
                        pts.append(p)
            for i in range(1, order):
                for j in range(1, order):
                    for k in range(1, order):
                        pts.append(np.array([-1 + 2 * i / order,
                                             -1 + 2 * j / order,
                                             -1 + 2 * k / order]))
        elif cell == "tri":
            # interior nodes at barycentric lattice
            for i in range(1, order):
                for j in range(1, order - i):
                    pts.append(np.array([i / order, j / order]))
        elif cell == "tet":
            for f in topo.faces:
                c = topo.corners[list(f)]
                for i in range(1, order):
                    for j in range(1, order - i):
                        l1, l2 = i / order, j / order
                        pts.append((1 - l1 - l2) * c[0] + l1 * c[1] + l2 * c[2])
            for i in range(1, order):
                for j in range(1, order - i):
                    for k in range(1, order - i - j):
                        pts.append(np.array([i / order, j / order, k / order]))
        elif cell == "line":
            pass  # edge nodes already added (line's single edge)
    return np.array(pts, dtype=np.float64)


def _eval_monomials(exps, pts):
    """(nmono, npts) monomial values."""
    vals = np.ones((len(exps), pts.shape[0]))
    for m, e in enumerate(exps):
        for d, p in enumerate(e):
            if p:
                vals[m] *= pts[:, d] ** p
    return vals


def _eval_monomial_grads(exps, pts):
    """(nmono, npts, dim) monomial gradients."""
    dim = pts.shape[1]
    out = np.zeros((len(exps), pts.shape[0], dim))
    for m, e in enumerate(exps):
        for gd in range(dim):
            if e[gd] == 0:
                continue
            g = np.full(pts.shape[0], float(e[gd]))
            for d, p in enumerate(e):
                q = p - 1 if d == gd else p
                if q:
                    g *= pts[:, d] ** q
            out[m, :, gd] = g
    return out


@dataclass(frozen=True)
class Basis:
    """A scalar nodal basis on a reference cell."""

    cell: str
    space: str            # "HGRAD" | "HVOL"
    order: int
    ndof: int
    dof_coords: np.ndarray                  # (ndof, dim) — nodal points
    _coeffs: np.ndarray = field(repr=False)  # (ndof, nmono)
    _exps: tuple = field(repr=False)

    @property
    def dim(self) -> int:
        return cell_topology(self.cell).dim

    def eval(self, pts: np.ndarray) -> np.ndarray:
        """Basis values, shape (ndof, npts)."""
        if self.space == "HVOL":
            return np.ones((1, pts.shape[0]))
        return self._coeffs @ _eval_monomials(self._exps, pts)

    def grad(self, pts: np.ndarray) -> np.ndarray:
        """Basis gradients, shape (ndof, npts, dim)."""
        if self.space == "HVOL":
            return np.zeros((1, pts.shape[0], self.dim))
        return np.einsum("im,mpd->ipd", self._coeffs,
                         _eval_monomial_grads(self._exps, pts))

    # ---- dof topology (used by the DOF manager) ----

    def dof_entities(self):
        """List of ('node'|'edge'|'face'|'cell', entity_index, k) per dof.

        k orders multiple dofs on the same entity deterministically.
        """
        topo = cell_topology(self.cell)
        if self.space == "HVOL":
            return [("cell", 0, 0)]
        ents = [("node", i, 0) for i in range(topo.n_corner)]
        if self.order >= 2:
            for ei in range(len(topo.edges)):
                for k in range(self.order - 1):
                    ents.append(("edge", ei, k))
            n_face_int = {
                "quad": 0, "tri": 0, "line": 0,
                "hex": (self.order - 1) ** 2,
                "tet": (self.order - 1) * (self.order - 2) // 2,
            }[self.cell]
            if topo.dim == 3:
                for fi in range(len(topo.faces)):
                    for k in range(n_face_int):
                        ents.append(("face", fi, k))
            n_int = {
                "line": 0,
                "quad": (self.order - 1) ** 2,
                "tri": (self.order - 1) * (self.order - 2) // 2,
                "hex": (self.order - 1) ** 3,
                "tet": max((self.order - 1) * (self.order - 2)
                           * (self.order - 3) // 6, 0),
            }[self.cell]
            for k in range(n_int):
                ents.append(("cell", 0, k))
        assert len(ents) == self.ndof, (len(ents), self.ndof)
        return ents

    def side_dofs(self, side: int) -> list[int]:
        """Local dof indices whose support includes the given side."""
        topo = cell_topology(self.cell)
        if self.space == "HVOL":
            return []
        on = []
        side_nodes = set(topo.sides[side])
        for i, (kind, idx, _k) in enumerate(self.dof_entities()):
            if kind == "node" and idx in side_nodes:
                on.append(i)
            elif kind == "edge" and set(topo.edges[idx]) <= side_nodes:
                on.append(i)
            elif kind == "face" and topo.dim == 3 and idx == side:
                on.append(i)
        return on


@lru_cache(maxsize=None)
def get_basis(cell: str, space: str, order: int) -> Basis:
    space = space.upper()
    if space == "HVOL":
        return Basis(cell=cell, space="HVOL", order=0, ndof=1,
                     dof_coords=np.zeros((1, cell_topology(cell).dim)),
                     _coeffs=np.ones((1, 1)), _exps=((0,),))
    if space == "HGRAD-DG":
        # broken nodal basis (element-local dofs): same reference
        # functions as HGRAD; the dofmap numbers its dofs per cell
        # (reference: 'Active variables: HGRAD-DG' decks)
        import dataclasses
        b = get_basis(cell, "HGRAD", order)
        return dataclasses.replace(b, space="HGRAD-DG")
    if space != "HGRAD":
        raise ValueError(f"basis space {space!r} not handled here; "
                         "see mrhyde_tpu_torch.fem.vector_basis")
    if order < 1:
        raise ValueError("HGRAD order must be >= 1")
    exps = tuple(_monomials(cell, order))
    nodes = _lagrange_nodes(cell, order)
    if len(exps) != nodes.shape[0]:
        raise ValueError(
            f"node/monomial count mismatch for {cell} p{order}: "
            f"{nodes.shape[0]} nodes vs {len(exps)} monomials")
    V = _eval_monomials(exps, nodes)          # (nmono, nnode)
    # basis_j = sum_m coeffs[j, m] mono_m with basis_j(node_i) = delta_ij
    coeffs = np.linalg.inv(V)
    return Basis(cell=cell, space="HGRAD", order=order, ndof=len(exps),
                 dof_coords=nodes, _coeffs=coeffs, _exps=exps)
