"""Vector-valued bases: HDIV (Raviart-Thomas) and HCURL (Nedelec), order 1.

TPU-native replacement for the Intrepid2 HDIV/HCURL bases + orientation
tools the reference relies on (reference:
src/interfaces/discretizationInterface.cpp:354-430 basis factory, :1263
orientations). Degrees of freedom:

- HDIV:  one per facet (edge in 2D, face in 3D); dof = facet flux
         int_f v . n with the *global* normal convention (from sorted
         global node ids). Piola (contravariant) map to physical:
         v_phys = J v_ref / det J, div_phys = div_ref / det J.
- HCURL: one per edge; dof = edge circulation int_e v . t with the
         global tangent convention (lower -> higher global node id).
         Covariant map: v_phys = J^{-T} v_ref;
         curl_phys = (scalar) curl_ref / det J in 2D,
         J curl_ref / det J in 3D.

Orientation: each element carries a +-1 sign per vector dof comparing
its local facet/edge orientation with the global convention; the sign
folds into gather/scatter (see fem.dofmap.build_dofmap and the
assembler), which reproduces Intrepid2 OrientationTools behavior for
lowest order.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np

from mrhyde_tpu_torch.fem.topology import cell_topology

__all__ = ["VectorBasis", "get_vector_basis", "hface_side_vals"]


def hface_side_vals(order: int, s_pts: np.ndarray) -> np.ndarray:
    """(npe, Qf) HFACE facet basis values at side params in [-1, 1].

    Rows are ordered by position along the edge (matching the dofmap's
    low-corner -> high-corner global numbering; flipped elements get
    the reversed row index, which is consistent because equally-spaced
    nodal line bases satisfy psi_{n-k}(-xi) = psi_k(xi)).
    """
    pts = np.atleast_1d(np.asarray(s_pts, dtype=float)).reshape(-1)
    if order == 0:
        return np.ones((1, pts.shape[0]))
    from mrhyde_tpu_torch.fem.basis import get_basis
    b = get_basis("line", "HGRAD", order)
    vals = b.eval(pts[:, None])                  # (npe, Qf)
    perm = np.argsort(b.dof_coords[:, 0])
    return vals[perm]


@dataclass(frozen=True)
class VectorBasis:
    cell: str
    space: str        # "HDIV" | "HCURL"
    order: int
    ndof: int
    # entity kind per dof: ("edge", idx) or ("face", idx)
    dof_entity: tuple

    @property
    def dim(self):
        return cell_topology(self.cell).dim

    # each concrete basis provides _eval/_div/_curl on reference coords
    @property
    def _lookup(self):
        s = self.space[:-3] if self.space.endswith("-DG") else self.space
        return s

    def eval(self, pts: np.ndarray) -> np.ndarray:
        """(ndof, npts, dim) reference vector values."""
        return _EVAL[(self.cell, self._lookup, self.order)](pts)

    def div(self, pts: np.ndarray) -> np.ndarray:
        """(ndof, npts) reference divergence (HDIV only)."""
        return _DIV[(self.cell, self._lookup, self.order)](pts)

    def curl(self, pts: np.ndarray) -> np.ndarray:
        """HCURL curl: (ndof, npts) in 2D, (ndof, npts, 3) in 3D."""
        return _CURL[(self.cell, self._lookup, self.order)](pts)

    def dof_entities(self):
        out = []
        for kind, idx in self.dof_entity:
            out.append((kind, idx, 0))
        return out

    def side_dofs(self, side: int) -> list[int]:
        topo = cell_topology(self.cell)
        out = []
        for i, (kind, idx) in enumerate(self.dof_entity):
            if kind == "cell":
                continue
            if kind == "face" and idx == side:
                out.append(i)
            elif kind == "edge" and topo.dim == 2 and idx == side:
                out.append(i)
            elif kind == "edge" and topo.dim == 3 \
                    and set(topo.edges[idx]) <= set(topo.sides[side]):
                out.append(i)
        return out


# ---------------------------------------------------------------------------
# reference-element definitions (lowest order)
# ---------------------------------------------------------------------------

def _hdiv_quad_eval(p):
    x, y = p[:, 0], p[:, 1]
    z = np.zeros_like(x)
    # edges (0,1) bottom, (1,2) right, (2,3) top, (3,0) left; outward flux
    return np.array([
        np.stack([z, (y - 1) / 4], axis=-1),
        np.stack([(1 + x) / 4, z], axis=-1),
        np.stack([z, (1 + y) / 4], axis=-1),
        np.stack([(x - 1) / 4, z], axis=-1),
    ])


def _hdiv_quad_div(p):
    n = p.shape[0]
    return np.full((4, n), 0.25)


# RT[1] on the reference quad (Intrepid2 HDIV_QUAD_In degree 2 span:
# x-component in Q_{2,1}, y-component in Q_{1,2}, 12 dofs). Used as a
# BROKEN (DG) space, so any basis of the span is equivalent; a simple
# monomial-product basis keeps eval/div closed-form.
_RT1_X = [(0, 0), (1, 0), (2, 0), (0, 1), (1, 1), (2, 1)]  # x^i y^j
_RT1_Y = [(0, 0), (0, 1), (0, 2), (1, 0), (1, 1), (1, 2)]


def _hdiv2_quad_eval(p):
    x, y = p[:, 0], p[:, 1]
    z = np.zeros_like(x)
    out = []
    for (i, j) in _RT1_X:
        out.append(np.stack([x ** i * y ** j, z], axis=-1))
    for (i, j) in _RT1_Y:
        out.append(np.stack([z, x ** i * y ** j], axis=-1))
    return np.array(out)


def _hdiv2_quad_div(p):
    x, y = p[:, 0], p[:, 1]
    out = []
    for (i, j) in _RT1_X:
        out.append(i * x ** max(i - 1, 0) * y ** j if i else 0 * x)
    for (i, j) in _RT1_Y:
        out.append(j * x ** i * y ** max(j - 1, 0) if j else 0 * x)
    return np.array(out)


def _hdiv_ac_quad_eval(p):
    """Arbogast-Correa AC_QUAD I1 (reference: in-tree
    Intrepid2_HDIV_AC_QUAD_I1_FEMDef.hpp:69-93)."""
    x, y = p[:, 0], p[:, 1]
    z = np.zeros_like(x)
    one = np.ones_like(x)
    return np.array([
        np.stack([z, one], axis=-1),
        np.stack([one, z], axis=-1),
        np.stack([0.5 * (1.0 + x), 0.5 * (1.0 + y)], axis=-1),
        np.stack([x, -y], axis=-1),
    ])


def _hdiv_ac_quad_div(p):
    n = p.shape[0]
    out = np.zeros((4, n))
    out[2] = 1.0
    return out


def _hcurl_quad_eval(p):
    x, y = p[:, 0], p[:, 1]
    z = np.zeros_like(x)
    # circulation along local edge direction
    return np.array([
        np.stack([(1 - y) / 4, z], axis=-1),       # (0,1): +x
        np.stack([z, (1 + x) / 4], axis=-1),       # (1,2): +y
        np.stack([-(1 + y) / 4, z], axis=-1),      # (2,3): -x
        np.stack([z, -(1 - x) / 4], axis=-1),      # (3,0): -y
    ])


def _hcurl_quad_curl(p):
    n = p.shape[0]
    return np.full((4, n), 0.25)


def _tri_lambdas(p):
    x, y = p[:, 0], p[:, 1]
    lam = np.stack([1 - x - y, x, y])              # (3, n)
    dlam = np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]])  # (3, dim)
    return lam, dlam


def _hdiv_tri_eval(p):
    x = p                                          # (n, 2)
    verts = cell_topology("tri").corners
    # edge i opposite vertex: sides (0,1)->2, (1,2)->0, (2,0)->1
    opp = [2, 0, 1]
    A = 0.5
    return np.array([(x - verts[opp[i]][None, :]) / (2 * A)
                     for i in range(3)])


def _hdiv_tri_div(p):
    n = p.shape[0]
    return np.full((3, n), 2.0)                    # 2/(2A), A = 1/2


def _whitney_edges(p, cell):
    topo = cell_topology(cell)
    if cell == "tri":
        lam, dlam = _tri_lambdas(p)
    else:  # tet
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        lam = np.stack([1 - x - y - z, x, y, z])
        dlam = np.array([[-1.0, -1, -1], [1, 0, 0], [0, 1, 0], [0, 0, 1]])
    vals, curls = [], []
    for (i, j) in topo.edges:
        v = lam[i][:, None] * dlam[j][None, :] \
            - lam[j][:, None] * dlam[i][None, :]
        vals.append(v)
        if cell == "tri":
            c = 2 * (dlam[i][0] * dlam[j][1] - dlam[i][1] * dlam[j][0])
            curls.append(np.full(p.shape[0], c))
        else:
            c = 2 * np.cross(dlam[i], dlam[j])
            curls.append(np.tile(c, (p.shape[0], 1)))
    return np.array(vals), np.array(curls)


def _hcurl_tri_eval(p):
    return _whitney_edges(p, "tri")[0]


def _hcurl_tri_curl(p):
    return _whitney_edges(p, "tri")[1]


def _hdiv_hex_eval(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    o = np.zeros_like(x)
    # faces: 0 z-, 1 z+, 2 y-, 3 x+, 4 y+, 5 x- (topology.sides order)
    return np.array([
        np.stack([o, o, (z - 1) / 8], axis=-1),
        np.stack([o, o, (z + 1) / 8], axis=-1),
        np.stack([o, (y - 1) / 8, o], axis=-1),
        np.stack([(x + 1) / 8, o, o], axis=-1),
        np.stack([o, (y + 1) / 8, o], axis=-1),
        np.stack([(x - 1) / 8, o, o], axis=-1),
    ])


def _hdiv_hex_div(p):
    n = p.shape[0]
    return np.full((6, n), 0.125)


def _hcurl_hex_eval(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    topo = cell_topology("hex")
    corners = topo.corners
    vals = []
    for (a, b) in topo.edges:
        d = (corners[b] - corners[a]) / 2.0        # unit direction * 1
        # profile: product of (1 +- coord)/2 over the two transverse axes
        prof = np.ones_like(x) / 8.0
        for ax in range(3):
            if d[ax] != 0:
                continue
            c = corners[a][ax]                     # +-1
            coord = p[:, ax]
            prof = prof * (1 + c * coord)
        v = prof[:, None] * d[None, :]
        vals.append(v)
    return np.array(vals)


def _hcurl_hex_curl(p):
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    topo = cell_topology("hex")
    corners = topo.corners
    curls = []
    for (a, b) in topo.edges:
        d = (corners[b] - corners[a]) / 2.0
        # v = prod_t (1 + c_t x_t)/8 * d  => curl = grad(prof) x d
        grad = np.zeros((p.shape[0], 3))
        for ax in range(3):
            if d[ax] != 0:
                continue
            c = corners[a][ax]
            g = np.full(p.shape[0], c / 8.0)
            for ax2 in range(3):
                if ax2 == ax or d[ax2] != 0:
                    continue
                c2 = corners[a][ax2]
                g = g * (1 + c2 * p[:, ax2])
            grad[:, ax] = g
        curls.append(np.cross(grad, np.tile(d, (p.shape[0], 1))))
    return np.array(curls)


def _hdiv_tet_eval(p):
    verts = cell_topology("tet").corners
    # sides (0,1,3)->opp 2, (1,2,3)->opp 0, (0,3,2)->opp 1, (0,2,1)->opp 3
    opp = [2, 0, 1, 3]
    V = 1.0 / 6.0
    return np.array([(p - verts[opp[i]][None, :]) / (3 * V)
                     for i in range(4)])


def _hdiv_tet_div(p):
    n = p.shape[0]
    return np.full((4, n), 6.0)                    # 3/(3V) = 1/V


def _hcurl_tet_eval(p):
    return _whitney_edges(p, "tet")[0]


def _hcurl_tet_curl(p):
    return _whitney_edges(p, "tet")[1]


_EVAL = {
    ("quad", "HDIV", 1): _hdiv_quad_eval,
    ("quad", "HDIV", 2): _hdiv2_quad_eval,
    ("quad", "HDIV_AC", 1): _hdiv_ac_quad_eval,
    ("quad", "HCURL", 1): _hcurl_quad_eval,
    ("tri", "HDIV", 1): _hdiv_tri_eval,
    ("tri", "HCURL", 1): _hcurl_tri_eval,
    ("hex", "HDIV", 1): _hdiv_hex_eval,
    ("hex", "HCURL", 1): _hcurl_hex_eval,
    ("tet", "HDIV", 1): _hdiv_tet_eval,
    ("tet", "HCURL", 1): _hcurl_tet_eval,
}
_DIV = {
    ("quad", "HDIV", 1): _hdiv_quad_div,
    ("quad", "HDIV", 2): _hdiv2_quad_div,
    ("quad", "HDIV_AC", 1): _hdiv_ac_quad_div,
    ("tri", "HDIV", 1): _hdiv_tri_div,
    ("hex", "HDIV", 1): _hdiv_hex_div,
    ("tet", "HDIV", 1): _hdiv_tet_div,
}
_CURL = {
    ("quad", "HCURL", 1): _hcurl_quad_curl,
    ("tri", "HCURL", 1): _hcurl_tri_curl,
    ("hex", "HCURL", 1): _hcurl_hex_curl,
    ("tet", "HCURL", 1): _hcurl_tet_curl,
}
_NDOF = {k: len(f(np.zeros((1, 2 if k[0] in ("quad", "tri") else 3))))
         for k, f in _EVAL.items()}


@lru_cache(maxsize=None)
def get_vector_basis(cell: str, space: str, order: int = 1) -> VectorBasis:
    space = space.upper()
    if space.startswith("HDIV_AC"):
        # Arbogast-Correa: degree 1 on quads only (reference basis
        # factory, discretizationInterface.cpp:400-415)
        order = 1
    topo = cell_topology(cell)
    if order >= 2 and space.replace("-DG", "") in ("HDIV", "HCURL") \
            and cell in ("quad", "tri", "hex", "tet"):
        _ensure_order(cell, space.replace("-DG", ""), order)
    if space.endswith("-DG") and space != "HFACE":
        # broken (element-local) spaces: all dofs are cell dofs
        key = (cell, space[:-3], order)
        if key not in _EVAL:
            raise NotImplementedError(f"{space} order {order} on {cell}")
        n = _NDOF[key]
        ents = tuple(("cell", k) for k in range(n))
        return VectorBasis(cell=cell, space=space, order=order,
                           ndof=n, dof_entity=ents)
    if space in ("HDIV", "HCURL") and order >= 2 \
            and cell in ("quad", "tri", "hex", "tet"):
        ents = _GEN_ENTS[(cell, space, order)]
        return VectorBasis(cell=cell, space=space, order=order,
                           ndof=len(ents), dof_entity=ents)
    if space != "HFACE" and order != 1:
        raise NotImplementedError(
            f"continuous {space} order {order} on {cell}")
    if space == "HDIV":
        if topo.dim == 2:
            ents = tuple(("edge", i) for i in range(len(topo.edges)))
        else:
            ents = tuple(("face", i) for i in range(len(topo.sides)))
    elif space == "HCURL":
        ents = tuple(("edge", i) for i in range(len(topo.edges)))
    elif space == "HFACE":
        # scalar trace space (reference: in-tree Intrepid2_HFACE_*
        # bases, src/tools/Intrepid2_HFACE_*.hpp): per-facet line
        # polynomials of degree `order`; order 0 = facet constants.
        # Each facet's dofs are independent (discontinuous at corners).
        if topo.dim == 1:
            # 1D facets are vertices: one trace dof per side regardless
            # of the requested order (a point value is a constant)
            ents = tuple(("face", i) for i in range(len(topo.sides)))
            return VectorBasis(cell=cell, space="HFACE", order=0,
                               ndof=len(ents), dof_entity=ents)
        if topo.dim == 2:
            npe = order + 1
            ents = tuple(("edge", i)
                         for i in range(len(topo.edges))
                         for _ in range(npe))
        else:
            # order n on hex/tet: npf nodal lattice dofs per face
            # (reference: src/tools/Intrepid2_HFACE_HEX/TET*.hpp);
            # cross-element index permutation in fem/dofmap.py
            npf = hface_npf(cell, order)
            ents = tuple(("face", i)
                         for i in range(len(topo.sides))
                         for _ in range(npf))
        return VectorBasis(cell=cell, space="HFACE", order=order,
                           ndof=len(ents), dof_entity=ents)
    else:
        raise ValueError(space)
    if (cell, space, 1) not in _EVAL:
        raise NotImplementedError(f"{space} on {cell}")
    return VectorBasis(cell=cell, space=space, order=1, ndof=len(ents),
                       dof_entity=ents)


# ---------------------------------------------------------------------------
# arbitrary-order bases (reference: Intrepid2 HDIV/HCURL_QUAD/TRI_In,
# discretizationInterface.cpp:354-430 serves any order; orientations
# :1263). Construction is NODAL so orientation folding stays a
# permutation + sign per shared edge (fem/dofmap.py):
#
# - quad: tensor-product Lagrange lattices. RT[n]: v_x in Q_{n,n-1}
#   (x-nodes: endpoints + interior Gauss; y-nodes: n Gauss), v_y
#   mirrored. Edge dofs = v.n_out at the n Gauss points ordered along
#   the topo edge traversal; interior dofs = component values at
#   interior lattice points. Nedelec[n] is the 90-degree rotation
#   (edge dofs = v.t along the traversal).
# - tri: monomial span (P_{k-1})^2 (+) x~ P~_{k-1} with nodal
#   functionals, inverted numerically (generalized Vandermonde).
#
# Symmetric edge-node sets make the flip rule exact: the reversed
# element indexes dof (n-1-i) and flips the sign (normal/tangent
# reversal), matching the lowest-order sign convention.
# ---------------------------------------------------------------------------


def _gauss_nodes(n):
    return np.polynomial.legendre.leggauss(n)[0] if n > 0 else \
        np.zeros(0)


@lru_cache(maxsize=None)
def _lagrange_coef(nodes_key):
    """Monomial coefficients (n_nodes, n_nodes) of the Lagrange basis
    on the given 1D nodes: L_a(x) = sum_p C[a, p] x^p."""
    nodes = np.asarray(nodes_key)
    V = np.vander(nodes, increasing=True)        # V[i, p] = x_i^p
    return np.linalg.inv(V).T                    # rows = basis funcs


def _poly_eval(C, x, deriv=0):
    """Evaluate Lagrange rows of C (from _lagrange_coef) at x."""
    n = C.shape[1]
    p = np.arange(n)
    if deriv == 0:
        X = x[None, :] ** p[:, None]             # (n, npts)
        return C @ X
    fac = p.copy().astype(float)
    X = np.zeros((n, x.shape[0]))
    X[1:] = x[None, :] ** (p[:-1][:, None])
    return (C * fac[None, :]) @ X


def _quad_node_sets(n):
    """(N, E): the (n+1)-point 'normal' set incl. endpoints and the
    n-point Gauss 'tangential' set, both symmetric."""
    interior = _gauss_nodes(n - 1)
    N = np.concatenate([[-1.0], interior, [1.0]])
    E = _gauss_nodes(n)
    return tuple(N), tuple(E)


def _hdiv_quad_order_n(n):
    """Closed-form RT[n] on the reference quad; returns
    (eval, div, dof_entity). Edge dof order follows topo.edges
    traversal; interior dofs after."""
    Nk, Ek = _quad_node_sets(n)
    N = np.asarray(Nk)
    E = np.asarray(Ek)
    CN = _lagrange_coef(Nk)
    CE = _lagrange_coef(Ek)
    nN, nE = len(N), len(E)

    # dof table: list of ("x"|"y" component, a_idx, b_idx, scale)
    # where v_x = LN_a(x) LE_b(y), v_y = LE_a(x) LN_b(y)
    dofs = []
    ents = []
    # edges: ((0,1) bottom y=-1, (1,2) right x=+1, (2,3) top y=+1,
    # (3,0) left x=-1); traversal directions: bottom +x, right +y,
    # top -x, left -y; outward normals (0,-1),(1,0),(0,1),(-1,0)
    for i in range(nE):                       # bottom: v.n = -v_y
        dofs.append(("y", i, 0, -1.0))
        ents.append(("edge", 0))
    for i in range(nE):                       # right: v.n = +v_x
        dofs.append(("x", nN - 1, i, 1.0))
        ents.append(("edge", 1))
    for i in range(nE):                       # top (-x traversal)
        dofs.append(("y", nE - 1 - i, nN - 1, 1.0))
        ents.append(("edge", 2))
    for i in range(nE):                       # left (-y traversal)
        dofs.append(("x", 0, nE - 1 - i, -1.0))
        ents.append(("edge", 3))
    for a in range(1, nN - 1):                # interior v_x
        for b in range(nE):
            dofs.append(("x", a, b, 1.0))
            ents.append(("cell", len(ents)))
    for a in range(nE):                       # interior v_y
        for b in range(1, nN - 1):
            dofs.append(("y", a, b, 1.0))
            ents.append(("cell", len(ents)))

    def ev(p, deriv=False):
        x, y = p[:, 0], p[:, 1]
        LNx = _poly_eval(CN, x)
        LNy = _poly_eval(CN, y)
        LEx = _poly_eval(CE, x)
        LEy = _poly_eval(CE, y)
        dLNx = _poly_eval(CN, x, 1)
        dLNy = _poly_eval(CN, y, 1)
        out_v = np.zeros((len(dofs), p.shape[0], 2))
        out_d = np.zeros((len(dofs), p.shape[0]))
        for k, (comp, a, b, s) in enumerate(dofs):
            if comp == "x":
                out_v[k, :, 0] = s * LNx[a] * LEy[b]
                out_d[k] = s * dLNx[a] * LEy[b]
            else:
                out_v[k, :, 1] = s * LEx[a] * LNy[b]
                out_d[k] = s * LEx[a] * dLNy[b]
        return out_d if deriv else out_v

    return (lambda p: ev(p)), (lambda p: ev(p, True)), tuple(ents)


def _hcurl_quad_order_n(n):
    """Nedelec[n] on the reference quad: v_x in Q_{n-1,n},
    v_y in Q_{n,n-1}; edge dofs = v.t along the traversal."""
    Nk, Ek = _quad_node_sets(n)
    CN = _lagrange_coef(Nk)
    CE = _lagrange_coef(Ek)
    nN, nE = len(Nk), len(Ek)
    dofs = []
    ents = []
    # v_x = LE_a(x) LN_b(y); v_y = LN_a(x) LE_b(y)
    for i in range(nE):                       # bottom, t = +x
        dofs.append(("x", i, 0, 1.0))
        ents.append(("edge", 0))
    for i in range(nE):                       # right, t = +y
        dofs.append(("y", nN - 1, i, 1.0))
        ents.append(("edge", 1))
    for i in range(nE):                       # top, t = -x
        dofs.append(("x", nE - 1 - i, nN - 1, -1.0))
        ents.append(("edge", 2))
    for i in range(nE):                       # left, t = -y
        dofs.append(("y", 0, nE - 1 - i, -1.0))
        ents.append(("edge", 3))
    for a in range(nE):                       # interior v_x
        for b in range(1, nN - 1):
            dofs.append(("x", a, b, 1.0))
            ents.append(("cell", len(ents)))
    for a in range(1, nN - 1):                # interior v_y
        for b in range(nE):
            dofs.append(("y", a, b, 1.0))
            ents.append(("cell", len(ents)))

    def ev(p, curl=False):
        x, y = p[:, 0], p[:, 1]
        LNx = _poly_eval(CN, x)
        LNy = _poly_eval(CN, y)
        LEx = _poly_eval(CE, x)
        LEy = _poly_eval(CE, y)
        dLNx = _poly_eval(CN, x, 1)
        dLNy = _poly_eval(CN, y, 1)
        out_v = np.zeros((len(dofs), p.shape[0], 2))
        out_c = np.zeros((len(dofs), p.shape[0]))
        for k, (comp, a, b, s) in enumerate(dofs):
            if comp == "x":
                out_v[k, :, 0] = s * LEx[a] * LNy[b]
                out_c[k] = -s * LEx[a] * dLNy[b]    # -d v_x/dy
            else:
                out_v[k, :, 1] = s * LNx[a] * LEy[b]
                out_c[k] = s * dLNx[a] * LEy[b]     # +d v_y/dx
        return out_c if curl else out_v

    return (lambda p: ev(p)), (lambda p: ev(p, True)), tuple(ents)


def _tri_span(space, k):
    """Monomial span builder for tri RT[k]/Ned[k]: returns
    (eval_span(p) -> (nsp, npts, 2), dspan(p) -> (nsp, npts))
    where dspan is div (RT) or scalar curl (Ned)."""
    polys = [(i, j) for d in range(k) for i in range(d + 1)
             for j in range(d + 1) if i + j == d]

    def ev(p):
        x, y = p[:, 0], p[:, 1]
        cols_v, cols_d = [], []
        for (i, j) in polys:                   # (m, 0)
            m = x ** i * y ** j
            cols_v.append(np.stack([m, 0 * m], -1))
            cols_d.append(i * x ** max(i - 1, 0) * y ** j
                          if i else 0 * m)
        for (i, j) in polys:                   # (0, m)
            m = x ** i * y ** j
            cols_v.append(np.stack([0 * m, m], -1))
            cols_d.append(j * x ** i * y ** max(j - 1, 0)
                          if j else 0 * m)
        for i in range(k):                     # x~ * homogeneous(k-1)
            j = k - 1 - i
            h = x ** i * y ** j
            cols_v.append(np.stack([x * h, y * h], -1))
            # div(x h, y h) = 2h + x hx + y hy = (k+1) h
            cols_d.append((k + 1) * h)
        return np.array(cols_v), np.array(cols_d)

    if space == "HDIV":
        return ev

    def ev_rot(p):                             # Ned = rot(RT)
        v, d = ev(p)
        vr = np.stack([-v[:, :, 1], v[:, :, 0]], -1)
        return vr, d                           # curl(rot w) = div w
    return ev_rot


@lru_cache(maxsize=None)
def _tri_order_n(space, k):
    """Vandermonde-built RT[k]/Nedelec[k] on the reference triangle
    ((0,0),(1,0),(0,1)): k nodal facet dofs per edge (Gauss points
    along the traversal) + interior component values."""
    topo = cell_topology("tri")
    span = _tri_span(space, k)
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    g01 = (_gauss_nodes(k) + 1.0) / 2.0        # edge params in (0,1)

    pts = []
    vecs = []
    ents = []
    for e, (a, b) in enumerate(topo.edges):
        pa, pb = verts[a], verts[b]
        t = pb - pa
        # UNNORMALIZED normal/tangent (length = reference edge
        # measure): pointwise flux/circulation-density functionals are
        # then Piola-invariant, so two elements mapping the same
        # physical edge from reference edges of different lengths
        # (axis vs diagonal on split-quad tris) share one dof value
        nrm = np.array([t[1], -t[0]])          # outward for ccw tris
        w = t if space == "HCURL" else nrm
        for s in g01:
            pts.append(pa + s * t)
            vecs.append(w)
            ents.append(("edge", e))
    # interior: component values at a strictly-interior lattice of
    # dim P_{k-2} points
    n_int = k * (k - 1) // 2
    if n_int:
        ip = []
        d = k - 2
        for i in range(d + 1):
            for j in range(d + 1 - i):
                ip.append([(i + 1) / (d + 3), (j + 1) / (d + 3)])
        ip = np.array(ip[:n_int])
        for q in ip:
            for w in (np.array([1.0, 0.0]), np.array([0.0, 1.0])):
                pts.append(q)
                vecs.append(w)
                ents.append(("cell", len(ents)))
    pts = np.array(pts)
    vecs = np.array(vecs)

    sp_v, _ = span(pts)                        # (nsp, ndof_pts, 2)
    V = np.einsum("snd,nd->ns", sp_v, vecs)    # V[dof, span]
    assert V.shape[0] == V.shape[1], (space, k, V.shape)
    cond = np.linalg.cond(V)
    assert cond < 1e10, f"{space}[{k}] tri Vandermonde cond {cond:.1e}"
    A = np.linalg.inv(V.T)                     # phi_j = sum_s A[j,s] s

    def ev(p):
        sv, _ = span(p)
        return np.einsum("js,snx->jnx", A, sv)

    def dv(p):
        _, sd = span(p)
        return A @ sd

    return ev, dv, tuple(ents)


# ---------------------------------------------------------------------------
# arbitrary-order 3D bases (reference: Intrepid2 HDIV/HCURL_HEX/TET_In,
# served by the basis factory at discretizationInterface.cpp:354-430 with
# OrientationTools folding at :1263). Same design as the 2D generalization
# above: NODAL functionals against UNNORMALIZED geometric vectors, which
# are Piola-invariant pointwise —
#   HDIV : f(v) = v . ((c1-c0) x (c2-c0)) at a face lattice point
#          (contravariant Piola maps this to the physical-face cross
#          vector: v_phys . (Ja x Jb) = v_ref . (a x b)),
#   HCURL: f(v) = v . (cb - ca) at an edge Gauss point (covariant Piola:
#          v_phys . (J t) = v_ref . t),
# so a shared entity's dof value depends only on the PHYSICAL entity
# geometry + the corner ordering. Cross-element consistency is then a
# lattice-index permutation plus a +-1 sign computed from the face
# corners' global ids (fem/dofmap.py), exactly like lowest order:
# - hex faces: the D4 symmetry group maps +-axis frames to +-axis
#   frames; symmetric Gauss lattices map onto themselves.
# - tet HDIV faces: S3 permutes the barycentric lattice; the cross
#   vector flips sign with permutation parity.
# - tet HCURL faces (order >= 2) need genuine 2x2 tangential-frame
#   mixing (the t0+t1+t2=0 redundancy) — not a signed permutation;
#   unimplemented (get_vector_basis raises).
# ---------------------------------------------------------------------------


def _hex_side_frame(s):
    """Per hex side: (na, ns, t1, t2) — outward-normal axis, its sign,
    and the two in-face axes in increasing order."""
    topo = cell_topology("hex")
    c = topo.corners[list(topo.sides[s])]          # (4, 3)
    n_out = np.cross(c[1] - c[0], c[3] - c[0])     # outward (ccw sides)
    na = int(np.argmax(np.abs(n_out)))
    ns = 1.0 if n_out[na] > 0 else -1.0
    t1, t2 = [ax for ax in range(3) if ax != na]
    return na, ns, t1, t2


def _hdiv_hex_order_n(n):
    """RT[n] on the reference hex: v_c in Q with degree n along axis c
    (nodes = endpoints + interior Gauss) and n-1 across (Gauss nodes).
    Face dofs = ns * v[na] at the n x n Gauss lattice (index a along
    t1, b along t2, both in increasing coordinate); interior after."""
    Nk, Ek = _quad_node_sets(n)
    CN, CE = _lagrange_coef(Nk), _lagrange_coef(Ek)
    nN, nE = len(Nk), len(Ek)
    topo = cell_topology("hex")

    dofs = []           # (comp, (i, j, k) tensor idx, scale)
    ents = []
    for s in range(len(topo.sides)):
        na, ns, t1, t2 = _hex_side_frame(s)
        na_idx = nN - 1 if ns > 0 else 0
        for a in range(nE):
            for b in range(nE):
                idx = [0, 0, 0]
                idx[na] = na_idx
                idx[t1] = a
                idx[t2] = b
                dofs.append((na, tuple(idx), ns))
                ents.append(("face", s))
    for c in range(3):
        t1, t2 = [ax for ax in range(3) if ax != c]
        for i in range(1, nN - 1):
            for a in range(nE):
                for b in range(nE):
                    idx = [0, 0, 0]
                    idx[c] = i
                    idx[t1] = a
                    idx[t2] = b
                    dofs.append((c, tuple(idx), 1.0))
                    ents.append(("cell", len(ents)))
    assert len(dofs) == 3 * n * n * (n + 1)

    def ev(p, deriv=False):
        L = {}
        dL = {}
        for ax in range(3):
            L[("N", ax)] = _poly_eval(CN, p[:, ax])
            L[("E", ax)] = _poly_eval(CE, p[:, ax])
            dL[ax] = _poly_eval(CN, p[:, ax], 1)
        out_v = np.zeros((len(dofs), p.shape[0], 3))
        out_d = np.zeros((len(dofs), p.shape[0]))
        for k, (c, idx, s) in enumerate(dofs):
            prof = np.ones(p.shape[0])
            for ax in range(3):
                if ax == c:
                    continue
                prof = prof * L[("E", ax)][idx[ax]]
            out_v[k, :, c] = s * L[("N", c)][idx[c]] * prof
            out_d[k] = s * dL[c][idx[c]] * prof
        return out_d if deriv else out_v

    return (lambda p: ev(p)), (lambda p: ev(p, True)), tuple(ents)


def _hcurl_hex_order_n(n):
    """Nedelec[n] on the reference hex: v_c in Q with degree n-1 along
    axis c (Gauss nodes) and n across (endpoint+Gauss nodes). Edge dofs
    = v . t_traversal at n Gauss points along each topo edge (listed in
    traversal order, so the dofmap's npe reversal+sign applies); face
    dofs = two +axis tangential components per face, each on a
    Gauss(n)-along x interior(n-1)-across lattice; interior after."""
    Nk, Ek = _quad_node_sets(n)
    CN, CE = _lagrange_coef(Nk), _lagrange_coef(Ek)
    nN, nE = len(Nk), len(Ek)
    topo = cell_topology("hex")
    corners = topo.corners

    dofs = []
    ents = []
    for e, (a, b) in enumerate(topo.edges):
        d = (corners[b] - corners[a]) / 2.0        # +-unit axis vector
        ax = int(np.argmax(np.abs(d)))
        sgn = 1.0 if d[ax] > 0 else -1.0
        t1, t2 = [u for u in range(3) if u != ax]
        i1 = 0 if corners[a][t1] < 0 else nN - 1
        i2 = 0 if corners[a][t2] < 0 else nN - 1
        for i in range(nE):
            # Gauss index i runs along the TRAVERSAL direction: for a
            # -axis edge, coordinate = -E[i] = E[nE-1-i]
            gi = i if sgn > 0 else nE - 1 - i
            idx = [0, 0, 0]
            idx[ax] = gi
            idx[t1] = i1
            idx[t2] = i2
            dofs.append((ax, tuple(idx), sgn))
            ents.append(("edge", e))
    for s in range(len(topo.sides)):
        na, ns, t1, t2 = _hex_side_frame(s)
        na_idx = nN - 1 if ns > 0 else 0
        for comp_ax, trans_ax in ((t1, t2), (t2, t1)):
            for a in range(nE):                    # along comp_ax
                for b in range(1, nN - 1):         # interior across
                    idx = [0, 0, 0]
                    idx[na] = na_idx
                    idx[comp_ax] = a
                    idx[trans_ax] = b
                    dofs.append((comp_ax, tuple(idx), 1.0))
                    ents.append(("face", s))
    for c in range(3):
        t1, t2 = [ax for ax in range(3) if ax != c]
        for i in range(nE):
            for a in range(1, nN - 1):
                for b in range(1, nN - 1):
                    idx = [0, 0, 0]
                    idx[c] = i
                    idx[t1] = a
                    idx[t2] = b
                    dofs.append((c, tuple(idx), 1.0))
                    ents.append(("cell", len(ents)))
    assert len(dofs) == 3 * n * (n + 1) ** 2

    def ev(p, curl=False):
        L = {}
        dLN = {}
        for ax in range(3):
            L[("N", ax)] = _poly_eval(CN, p[:, ax])
            L[("E", ax)] = _poly_eval(CE, p[:, ax])
            dLN[ax] = _poly_eval(CN, p[:, ax], 1)
        out_v = np.zeros((len(dofs), p.shape[0], 3))
        out_c = np.zeros((len(dofs), p.shape[0], 3))
        for k, (c, idx, s) in enumerate(dofs):
            t1, t2 = [ax for ax in range(3) if ax != c]
            f = L[("E", c)][idx[c]]
            g1 = L[("N", t1)][idx[t1]]
            g2 = L[("N", t2)][idx[t2]]
            dg1 = dLN[t1][idx[t1]]
            dg2 = dLN[t2][idx[t2]]
            out_v[k, :, c] = s * f * g1 * g2
            # curl of (0,..,v_c,..,0): (curl v)_a = eps_{a b c} d_b v_c
            for (a, b_ax, gb, go) in ((t2, t1, dg1, g2),
                                      (t1, t2, dg2, g1)):
                eps = _LEVI[(a, b_ax, c)]
                out_c[k, :, a] += eps * s * f * gb * go
        return out_c if curl else out_v

    return (lambda p: ev(p)), (lambda p: ev(p, True)), tuple(ents)


_LEVI = {(0, 1, 2): 1.0, (1, 2, 0): 1.0, (2, 0, 1): 1.0,
         (0, 2, 1): -1.0, (2, 1, 0): -1.0, (1, 0, 2): -1.0}


def _tet_span_hdiv(k):
    """Monomial span for tet RT[k]: (P_{k-1})^3 (+) x~ P~_{k-1}.
    Returns ev(p) -> (span values (nsp, npts, 3), divs (nsp, npts))."""
    polys = [(i, j, l) for d in range(k) for i in range(d + 1)
             for j in range(d + 1) for l in range(d + 1)
             if i + j + l == d]
    homog = [(i, j, l) for i in range(k) for j in range(k)
             for l in range(k) if i + j + l == k - 1]

    def ev(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        cols_v, cols_d = [], []
        for c in range(3):
            for (i, j, l) in polys:
                m = x ** i * y ** j * z ** l
                v = np.zeros((p.shape[0], 3))
                v[:, c] = m
                cols_v.append(v)
                cols_d.append(_mono_d(p, i, j, l, c))
        for (i, j, l) in homog:
            h = x ** i * y ** j * z ** l
            cols_v.append(p * h[:, None])
            # div(x h) = 3h + x.grad h = (3 + k - 1) h
            cols_d.append((k + 2) * h)
        return np.array(cols_v), np.array(cols_d)

    return ev


def _mono_d(p, i, j, l, c):
    """d/dx_c of x^i y^j z^l."""
    e = (i, j, l)
    if e[c] == 0:
        return np.zeros(p.shape[0])
    ee = list(e)
    ee[c] -= 1
    return e[c] * p[:, 0] ** ee[0] * p[:, 1] ** ee[1] * p[:, 2] ** ee[2]


@lru_cache(maxsize=None)
def _tet_hdiv_order_n(k):
    """Vandermonde-built RT[k] on the reference tet: per face, the
    degree k-1 barycentric lattice of pointwise cross-vector flux
    functionals f(v) = v.((c1-c0)x(c2-c0)) (corners in topo.sides
    traversal order, lattice in _facet_lattice flat order so
    fem/dofmap folds orientations with _hface3d_permutation + parity
    sign); interior component values after."""
    topo = cell_topology("tet")
    verts = topo.corners
    span = _tet_span_hdiv(k)
    lat = _facet_lattice("tri", k - 1) if k >= 2 else \
        np.array([[1.0 / 3.0, 1.0 / 3.0]])

    pts, vecs, ents = [], [], []
    for s, f in enumerate(topo.sides):
        c0, c1, c2 = verts[f[0]], verts[f[1]], verts[f[2]]
        nrm = np.cross(c1 - c0, c2 - c0)           # outward, area-scaled
        for (u, v) in lat:
            pts.append((1 - u - v) * c0 + u * c1 + v * c2)
            vecs.append(nrm)
            ents.append(("face", s))
    # interior: 3 components at a strictly-interior barycentric lattice
    # of dim P_{k-2} points
    if k >= 2:
        d = k - 2
        ip = []
        for i in range(d + 1):
            for j in range(d + 1 - i):
                for l in range(d + 1 - i - j):
                    ip.append([(i + 1.0) / (k + 2), (j + 1.0) / (k + 2),
                               (l + 1.0) / (k + 2)])
        for q in ip:
            for c in range(3):
                w = np.zeros(3)
                w[c] = 1.0
                pts.append(np.asarray(q))
                vecs.append(w)
                ents.append(("cell", len(ents)))
    pts = np.array(pts)
    vecs = np.array(vecs)

    sp_v, _ = span(pts)
    V = np.einsum("snd,nd->ns", sp_v, vecs)
    assert V.shape[0] == V.shape[1], ("HDIV tet", k, V.shape)
    cond = np.linalg.cond(V)
    assert cond < 1e12, f"RT[{k}] tet Vandermonde cond {cond:.1e}"
    A = np.linalg.inv(V.T)

    def ev(p):
        sv, _ = span(p)
        return np.einsum("js,snx->jnx", A, sv)

    def dv(p):
        _, sd = span(p)
        return A @ sd

    return ev, dv, tuple(ents)


def _tet_span_hcurl(k):
    """Monomial span for tet Nedelec-1st-kind[k]:
    (P_{k-1})^3 (+) S_k, S_k = {v homogeneous deg k : v.x = 0}.
    S_k generators: x cross (m e_c) for monomials m of degree k-1 —
    rank-selected via pivoted QR (the generator set has a
    dim-P~_{k-2} kernel). Every span element is a monomial dict
    {(i,j,l,c): coef}, so curls are exact.

    Returns ev(p) -> (values (nsp, npts, 3), curls (nsp, npts, 3))."""
    elems = []                               # list of dicts
    for c in range(3):
        for d in range(k):
            for i in range(d + 1):
                for j in range(d + 1 - i):
                    l = d - i - j
                    elems.append({(i, j, l, c): 1.0})
    # homogeneous generators: m of degree k-1
    gens = []
    for i in range(k):
        for j in range(k - i):
            l = k - 1 - i - j
            # x cross (m e_0) = (0, m z, -m y)
            gens.append({(i, j, l + 1, 1): 1.0, (i, j + 1, l, 2): -1.0})
            # x cross (m e_1) = (-m z, 0, m x)
            gens.append({(i, j, l + 1, 0): -1.0, (i + 1, j, l, 2): 1.0})
            # x cross (m e_2) = (m y, -m x, 0)
            gens.append({(i, j + 1, l, 0): 1.0, (i + 1, j, l, 1): -1.0})
    # rank-select k(k+2) independent generators
    keys = sorted({m for g in gens for m in g})
    G = np.zeros((len(keys), len(gens)))
    ki = {m: r for r, m in enumerate(keys)}
    for cidx, g in enumerate(gens):
        for m, coef in g.items():
            G[ki[m], cidx] = coef
    import scipy.linalg as sla
    _q, _r, piv = sla.qr(G, pivoting=True)
    need = k * (k + 2)
    elems.extend(gens[piv[t]] for t in range(need))

    def ev(p):
        x, y, z = p[:, 0], p[:, 1], p[:, 2]
        npts = p.shape[0]
        vals = np.zeros((len(elems), npts, 3))
        crls = np.zeros((len(elems), npts, 3))
        for s, g in enumerate(elems):
            for (i, j, l, c), coef in g.items():
                vals[s, :, c] += coef * x ** i * y ** j * z ** l
                # curl contributions of coef x^i y^j z^l e_c
                if c == 0:
                    if l:
                        crls[s, :, 1] += coef * l * \
                            x ** i * y ** j * z ** (l - 1)
                    if j:
                        crls[s, :, 2] -= coef * j * \
                            x ** i * y ** (j - 1) * z ** l
                elif c == 1:
                    if l:
                        crls[s, :, 0] -= coef * l * \
                            x ** i * y ** j * z ** (l - 1)
                    if i:
                        crls[s, :, 2] += coef * i * \
                            x ** (i - 1) * y ** j * z ** l
                else:
                    if j:
                        crls[s, :, 0] += coef * j * \
                            x ** i * y ** (j - 1) * z ** l
                    if i:
                        crls[s, :, 1] -= coef * i * \
                            x ** (i - 1) * y ** j * z ** l
        return vals, crls

    return ev


@lru_cache(maxsize=None)
def _tet_hcurl_order_n(k):
    """Vandermonde-built Nedelec-1[k] on the reference tet.

    Functionals (all POINTWISE circulation densities v.t against
    UNNORMALIZED corner-difference tangents, so they are covariant-
    Piola invariant and shareable across elements):
      - per edge (a, b): k Gauss points, tangent = corner_b - corner_a;
      - per face (topo.sides traversal c0,c1,c2): at each point of the
        degree k-2 barycentric lattice (_facet_lattice order), TWO dofs
        listed consecutively: components along t1 = c1-c0 and
        t2 = c2-c0. Cross-element consistency needs a 2x2 frame mix
        (tet_hcurl_face_mix) because the face symmetry group does not
        act by signed permutations on (t1, t2);
      - interior: 3 component values per point of a strictly-interior
        P_{k-3} lattice.

    Reference analog: Intrepid2 HCURL_TET_In_FEM + orientation tools
    (discretizationInterface.cpp:354-430, :1263)."""
    topo = cell_topology("tet")
    verts = topo.corners
    span = _tet_span_hcurl(k)
    g01 = (_gauss_nodes(k) + 1.0) / 2.0

    pts, vecs, ents = [], [], []
    for e, (a, b) in enumerate(topo.edges):
        pa, pb = verts[a], verts[b]
        t = pb - pa
        for s in g01:
            pts.append(pa + s * t)
            vecs.append(t)
            ents.append(("edge", e))
    if k >= 2:
        # STRICTLY-INTERIOR symmetric face lattice (i+1)/(deg+3): the
        # corner-touching _facet_lattice makes the k>=3 Vandermonde
        # singular (corner tangential values are dependent on the edge
        # functionals). Index order matches _facet_lattice /
        # tet_hcurl_face_mix's (i, j) flat enumeration.
        deg = k - 2
        lat = np.array([[(i + 1.0) / (deg + 3), (j + 1.0) / (deg + 3)]
                        for i in range(deg + 1)
                        for j in range(deg + 1 - i)])
        for s, f in enumerate(topo.sides):
            c0, c1, c2 = verts[f[0]], verts[f[1]], verts[f[2]]
            t1, t2 = c1 - c0, c2 - c0
            for (u, v) in lat:
                p = (1 - u - v) * c0 + u * c1 + v * c2
                for t in (t1, t2):
                    pts.append(p)
                    vecs.append(t)
                    ents.append(("face", s))
    if k >= 3:
        d = k - 3
        for i in range(d + 1):
            for j in range(d + 1 - i):
                for l in range(d + 1 - i - j):
                    q = np.array([(i + 1.0) / (k + 2),
                                  (j + 1.0) / (k + 2),
                                  (l + 1.0) / (k + 2)])
                    for c in range(3):
                        w = np.zeros(3)
                        w[c] = 1.0
                        pts.append(q)
                        vecs.append(w)
                        ents.append(("cell", len(ents)))
    pts = np.array(pts)
    vecs = np.array(vecs)

    sp_v, _ = span(pts)
    V = np.einsum("snd,nd->ns", sp_v, vecs)
    assert V.shape[0] == V.shape[1], ("HCURL tet", k, V.shape)
    cond = np.linalg.cond(V)
    assert cond < 1e12, f"Ned[{k}] tet Vandermonde cond {cond:.1e}"
    A = np.linalg.inv(V.T)

    def ev(p):
        sv, _ = span(p)
        return np.einsum("js,snx->jnx", A, sv)

    def cv(p):
        _, sc = span(p)
        return np.einsum("js,snx->jnx", A, sc)

    return ev, cv, tuple(ents)


@lru_cache(maxsize=None)
def tet_hcurl_face_mix(order: int, sigma: tuple):
    """Face-dof folding data for tet HCURL order >= 2.

    sigma = argsort of the face's 3 corner GLOBAL ids in the element's
    topo.sides traversal order. The face's canonical frame (shared by
    both elements) is d1 = P_{sigma1} - P_{sigma0},
    d2 = P_{sigma2} - P_{sigma0}; the local frame is t1 = P_1 - P_0,
    t2 = P_2 - P_0. Corner differences are integer combinations, so
    the 2x2 change-of-frame M (t_a = sum_b M[a,b] d_b) has entries in
    {0, +-1}; a local dof's COEFFICIENT gathers as
    u_loc = M @ u_canonical (nodal coefficients transform like their
    functionals).

    Returns (permlat, M): permlat maps local lattice slot -> canonical
    lattice slot (weights reordered by sigma, the _hface3d rule at
    degree order-2); M is the 2x2 mix."""
    sigma = np.asarray(sigma)
    deg = order - 2
    flat = {}
    m = 0
    for i in range(deg + 1):
        for j in range(deg + 1 - i):
            flat[(i, j)] = m
            m += 1
    permlat = np.zeros(len(flat), dtype=np.int64)
    for (i, j), mm in flat.items():
        w = (deg - i - j, i, j)
        wc = [w[sigma[0]], w[sigma[1]], w[sigma[2]]]
        permlat[mm] = flat[(wc[1], wc[2])]
    # rank of each traversal corner in the canonical order
    r = np.empty(3, dtype=np.int64)
    r[sigma] = np.arange(3)
    # D_0 = 0, D_1 = d1, D_2 = d2; t_a = D_{r[a]} - D_{r[0]}
    D = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    M = np.stack([D[r[1]] - D[r[0]], D[r[2]] - D[r[0]]])
    return permlat, M


# --- orientation folding tables for the dofmap --------------------------


@lru_cache(maxsize=None)
def face_perm_sign(cell: str, space: str, order: int, desc: tuple):
    """Within-face dof permutation + signs folding an element's local
    face-dof layout onto the face's canonical (global-id) frame.

    desc describes the face's global-id ordering as seen from THIS
    element's topo.sides traversal:
      hex: (side, k0, d) — local side index, argmin corner position in
           the traversal, and cyclic direction toward the smaller
           neighbor (+1/-1). The side index matters because the basis
           lattice lives in the side's increasing-axis (t1, t2) frame,
           which relates to the traversal differently per side.
      tet: sigma — tuple argsort of the 3 corner ids (stable).
    Returns (perm, sgn): local within-face dof j holds global lattice
    slot perm[j] with orientation sign sgn[j]."""
    n = order
    if cell == "tet":
        if space != "HDIV":
            raise NotImplementedError("tet HCURL face orientation "
                                      "needs 2x2 mixing (unsupported)")
        sigma = np.asarray(desc)
        npf = n * (n + 1) // 2
        # lattice permutation: weights (1-u-v, u, v) on traversal
        # corners reordered by sigma (same rule as _hface3d_permutation
        # at lattice degree n-1)
        perm = np.zeros(npf, dtype=np.int64)
        flat = {}
        m = 0
        deg = n - 1
        for i in range(deg + 1):
            for j in range(deg + 1 - i):
                flat[(i, j)] = m
                m += 1
        for (i, j), m in flat.items():
            w = (deg - i - j, i, j)
            wc = [w[sigma[0]], w[sigma[1]], w[sigma[2]]]
            perm[m] = flat[(wc[1], wc[2])]
        # parity of sigma: cross vector flips under odd permutation
        par = 1.0
        sg = list(desc)
        for i in range(len(sg)):
            while sg[i] != i:
                j = sg[i]
                sg[i], sg[j] = sg[j], sg[i]
                par = -par
        return perm, np.full(npf, par)
    # hex quad face: canonical frame from (side, k0, d), expressed in
    # the side's increasing-axis (t1, t2) lattice coordinates (the
    # frame _hdiv/_hcurl_hex_order_n lay their face lattices out in)
    s, k0, d = desc
    na, ns, t1, t2 = _hex_side_frame(s)
    topo = cell_topology("hex")
    cref = cell_topology("hex").corners[list(topo.sides[s])]
    uv = ((cref[:, [t1, t2]] + 1.0) / 2.0).astype(int)   # (4, 2) in {0,1}
    O = uv[k0]
    E1 = uv[(k0 + d) % 4] - O                      # canonical axis 1
    E2 = uv[(k0 - d) % 4] - O                      # canonical axis 2
    # in-face axis u is lattice index a, axis v is lattice index b
    if space == "HDIV":
        npf = n * n
        perm = np.zeros(npf, dtype=np.int64)
        for a in range(n):
            for b in range(n):
                ap = _canon_idx(E1, a, b, n)
                bp = _canon_idx(E2, a, b, n)
                perm[a * n + b] = ap * n + bp
        # sign = (e1c x e2c) . n_out in face-frame coords: det of
        # [E1; E2] (the local (u,v) frame is built so u x v = +n_out,
        # see _hdiv_hex_order_n's (t1, t2) increasing-axis convention
        # combined with ax_or folded below by the dofmap caller)
        det = float(E1[0] * E2[1] - E1[1] * E2[0])
        return perm, np.full(npf, det)
    # HCURL: per-component blocks; local block 1 = component along u
    # (lattice a in Gauss(n) along u, b in interior(n-1) along v),
    # block 2 = component along v
    nin = n - 1
    npf = 2 * n * nin
    perm = np.zeros(npf, dtype=np.int64)
    sgn = np.zeros(npf)
    for blk, (comp_ax, trans_ax) in enumerate(((0, 1), (1, 0))):
        # which canonical vector lies along comp_ax?
        if E1[comp_ax] != 0:
            cblk, alpha = 0, float(E1[comp_ax])
            beta = float(E2[trans_ax])
        else:
            cblk, alpha = 1, float(E2[comp_ax])
            beta = float(E1[trans_ax])
        for a in range(n):
            for b in range(nin):
                ap = a if alpha > 0 else n - 1 - a
                bp = b if beta > 0 else nin - 1 - b
                j = blk * n * nin + a * nin + b
                perm[j] = cblk * n * nin + ap * nin + bp
                sgn[j] = alpha
    return perm, sgn


def _canon_idx(E, a, b, n):
    """Index along a canonical axis vector E (in face (u,v) coords) of
    the local lattice point (a, b) on a symmetric n-point lattice."""
    if E[0] != 0:
        return a if E[0] > 0 else n - 1 - a
    return b if E[1] > 0 else n - 1 - b


def hex_face_axis_orientation(s: int) -> float:
    """Sign of (e_t1 x e_t2) . n_out for a hex side's increasing-axis
    in-face frame — the factor relating face_perm_sign's det (computed
    in (u, v) = (t1, t2) lattice coords) to the outward normal."""
    na, ns, t1, t2 = _hex_side_frame(s)
    e1 = np.zeros(3)
    e2 = np.zeros(3)
    e1[t1] = 1.0
    e2[t2] = 1.0
    nrm = np.cross(e1, e2)
    return float(np.sign(nrm[na]) * ns)


# registry of generically-built arbitrary-order bases
_GEN_ENTS: dict = {}


def _ensure_order(cell, space, order):
    """Build + register the arbitrary-order nodal basis for
    (cell, space, order) into the _EVAL/_DIV/_CURL tables (overwriting
    the span-equivalent monomial RT[1] broken basis at
    (quad, HDIV, 2) — broken spaces only see the span)."""
    key = (cell, space, order)
    if key in _GEN_ENTS:
        return
    if cell == "quad" and space == "HDIV":
        ev, dv, ents = _hdiv_quad_order_n(order)
        _DIV[key] = dv
    elif cell == "quad" and space == "HCURL":
        ev, dv, ents = _hcurl_quad_order_n(order)
        _CURL[key] = dv
    elif cell == "tri":
        ev, dv, ents = _tri_order_n(space, order)
        (_DIV if space == "HDIV" else _CURL)[key] = dv
    elif cell == "hex" and space == "HDIV":
        ev, dv, ents = _hdiv_hex_order_n(order)
        _DIV[key] = dv
    elif cell == "hex" and space == "HCURL":
        ev, dv, ents = _hcurl_hex_order_n(order)
        _CURL[key] = dv
    elif cell == "tet" and space == "HDIV":
        ev, dv, ents = _tet_hdiv_order_n(order)
        _DIV[key] = dv
    elif cell == "tet" and space == "HCURL":
        # face dofs fold with a 2x2 frame mix (tet_hcurl_face_mix);
        # fem/dofmap.py carries it in the mix_pair/mix_w channel
        ev, dv, ents = _tet_hcurl_order_n(order)
        _CURL[key] = dv
    else:
        raise NotImplementedError(f"{space} order {order} on {cell}")
    _EVAL[key] = ev
    _NDOF[key] = len(ents)
    _GEN_ENTS[key] = ents


# ---------------------------------------------------------------------------
# HFACE order >= 1 on 3D cells (reference: in-tree
# src/tools/Intrepid2_HFACE_HEX/TET*.hpp): per-face NODAL 2D polynomial
# traces. Nodal lattices are invariant under the face symmetry group,
# so cross-element consistency is a pure index permutation computed
# from the face corners' GLOBAL ids (fem/dofmap.py
# _hface3d_permutation) — the 3D generalization of the 2D edge
# reversal rule.
# ---------------------------------------------------------------------------


def _facet_lattice(side_cell: str, order: int):
    """Lattice enumeration for the facet nodal basis: list of
    reference-facet coordinates in OUR canonical flat order."""
    n = order
    if side_cell == "quad":
        xi = np.linspace(-1.0, 1.0, n + 1)
        return np.array([[xi[a], xi[b]]
                         for a in range(n + 1) for b in range(n + 1)])
    # tri: barycentric lattice (i, j), i + j <= n, coords (i/n, j/n);
    # degree 0 = the centroid
    if n == 0:
        return np.array([[1.0 / 3.0, 1.0 / 3.0]])
    return np.array([[i / n, j / n]
                     for i in range(n + 1) for j in range(n + 1 - i)])


@lru_cache(maxsize=None)
def _facet_perm_to_lattice(side_cell: str, order: int):
    """Row permutation taking get_basis(side_cell, HGRAD, order)'s dof
    order to our lattice order."""
    from mrhyde_tpu_torch.fem.basis import get_basis
    b = get_basis(side_cell, "HGRAD", order)
    lat = _facet_lattice(side_cell, order)
    perm = []
    for p in lat:
        d = np.linalg.norm(b.dof_coords - p[None, :], axis=1)
        k = int(np.argmin(d))
        assert d[k] < 1e-10, (side_cell, order, p)
        perm.append(k)
    assert len(set(perm)) == len(perm)
    return np.array(perm)


def hface_face_vals(cell_type: str, order: int,
                    s_pts: np.ndarray) -> np.ndarray:
    """(npf, Qf) HFACE facet basis values at 3D side params, rows in
    lattice order (matching the dofmap's canonical global numbering
    modulo the per-element permutation folded into eldofs)."""
    from mrhyde_tpu_torch.fem.basis import get_basis
    side_cell = "quad" if cell_type == "hex" else "tri"
    if order == 0:
        return np.ones((1, np.asarray(s_pts).shape[0]))
    b = get_basis(side_cell, "HGRAD", order)
    vals = b.eval(np.asarray(s_pts))
    return vals[_facet_perm_to_lattice(side_cell, order)]


def hface_npf(cell_type: str, order: int) -> int:
    if cell_type == "hex":
        return (order + 1) ** 2
    return (order + 1) * (order + 2) // 2
