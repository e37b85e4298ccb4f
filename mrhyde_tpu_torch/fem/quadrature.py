"""Quadrature rules on reference cells.

Rules are generated at setup time with numpy (never traced) and exactness
matches the reference's Intrepid2 cubature-degree convention
(reference: src/interfaces/discretizationInterface.cpp:467 getQuadrature):
a requested cubature degree d on a tensor cell uses n = d//2 + 1
Gauss-Legendre points per dimension (exact through degree 2n-1 >= d),
and symmetric rules of matching degree on simplices.
"""

from __future__ import annotations

import numpy as np

__all__ = ["gauss_legendre_1d", "cell_quadrature", "side_quadrature"]


def gauss_legendre_1d(n: int) -> tuple[np.ndarray, np.ndarray]:
    """n-point Gauss-Legendre rule on [-1, 1] (exact through degree 2n-1)."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    return pts.astype(np.float64), wts.astype(np.float64)


def _tensor_rule(n1d: int, dim: int) -> tuple[np.ndarray, np.ndarray]:
    p1, w1 = gauss_legendre_1d(n1d)
    if dim == 1:
        return p1[:, None], w1
    grids = np.meshgrid(*([p1] * dim), indexing="ij")
    pts = np.stack([g.ravel() for g in grids], axis=-1)
    wg = np.meshgrid(*([w1] * dim), indexing="ij")
    wts = np.ones(pts.shape[0])
    for w in wg:
        wts = wts * w.ravel()
    return pts, wts


# --- symmetric simplex rules (barycentric), standard Dunavant/Keast data ---

def _tri_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric rule on the unit triangle (0,0),(1,0),(0,1); area 1/2."""
    if degree <= 1:
        bary = [((1 / 3, 1 / 3, 1 / 3), 1.0)]
    elif degree == 2:
        bary = [((2 / 3, 1 / 6, 1 / 6), 1 / 3),
                ((1 / 6, 2 / 3, 1 / 6), 1 / 3),
                ((1 / 6, 1 / 6, 2 / 3), 1 / 3)]
    elif degree == 3:
        bary = [((1 / 3, 1 / 3, 1 / 3), -27 / 48)]
        for perm in _perms3(0.6, 0.2):
            bary.append((perm, 25 / 48))
    elif degree in (4, 5):
        a1, w1 = 0.059715871789770, 0.132394152788506
        a2, w2 = 0.797426985353087, 0.125939180544827
        bary = []
        for perm in _perms3(a1, (1 - a1) / 2):
            bary.append((perm, w1))
        for perm in _perms3(a2, (1 - a2) / 2):
            bary.append((perm, w2))
        bary.insert(0, ((1 / 3, 1 / 3, 1 / 3), 0.225))
    elif degree in (6, 7, 8):
        # Dunavant degree-8 16-point rule — the same direct positive-
        # weight table Intrepid2's CubatureDirectTriDefault uses, so
        # computed error norms match the reference digit-for-digit at
        # high order (thermal/2D_verification_tri_highorder)
        bary = [((1 / 3, 1 / 3, 1 / 3), 0.144315607677787)]
        for a, w in ((0.081414823414554, 0.095091634413245),
                     (0.658861384496480, 0.103217370534718),
                     (0.898905543365938, 0.032458497623198)):
            for perm in _perms3(a, (1 - a) / 2):
                bary.append((perm, w))
        c1, c2 = 0.008394777409958, 0.263112829634638
        c3 = 1.0 - c1 - c2
        for perm in {(c1, c2, c3), (c1, c3, c2), (c2, c1, c3),
                     (c2, c3, c1), (c3, c1, c2), (c3, c2, c1)}:
            bary.append((perm, 0.027230314174435))
    else:  # Gauss product fallback via collapsed square
        n = degree // 2 + 1
        p1, w1 = gauss_legendre_1d(n)
        # Duffy transform from [-1,1]^2 to unit triangle
        u = (p1 + 1) / 2
        pts, wts = [], []
        for i in range(n):
            for j in range(n):
                x = u[i] * (1 - u[j])
                y = u[j]
                pts.append((x, y))
                wts.append(w1[i] * w1[j] * (1 - u[j]) / 4.0)
        return np.array(pts), np.array(wts)
    pts = np.array([[b[1], b[2]] for b, _ in bary])
    wts = np.array([w for _, w in bary]) * 0.5  # reference area = 1/2
    return pts, wts


def _perms3(a, b):
    """Distinct permutations of the barycentric triple (a, b, b)."""
    out = {(a, b, b), (b, a, b), (b, b, a)}
    return sorted(out)


def _tet_rule(degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric rule on the unit tet (0,0,0),(1,0,0),(0,1,0),(0,0,1); vol 1/6."""
    if degree <= 1:
        pts = np.array([[0.25, 0.25, 0.25]])
        wts = np.array([1.0])
    elif degree == 2:
        a = (5 - np.sqrt(5)) / 20
        b = (5 + 3 * np.sqrt(5)) / 20
        base = np.full((4, 4), a)
        np.fill_diagonal(base, b)
        pts = base[:, 1:]
        wts = np.full(4, 0.25)
    elif degree == 3:
        pts = [[0.25, 0.25, 0.25]]
        wts = [-0.8]
        a, b = 1 / 6, 0.5
        base = np.full((4, 4), a)
        np.fill_diagonal(base, b)
        pts = np.vstack([pts, base[:, 1:]])
        wts = np.array(wts + [0.45] * 4)
    else:  # Duffy-collapsed Gauss product, exact to requested degree
        n = degree // 2 + 2
        p1, w1 = gauss_legendre_1d(n)
        u = (p1 + 1) / 2
        w = w1 / 2
        pts, wts = [], []
        for i in range(n):
            for j in range(n):
                for k in range(n):
                    x = u[i] * (1 - u[j]) * (1 - u[k])
                    y = u[j] * (1 - u[k])
                    z = u[k]
                    pts.append((x, y, z))
                    wts.append(w[i] * w[j] * w[k]
                               * (1 - u[j]) * (1 - u[k]) ** 2)
        return np.array(pts), np.array(wts)
    return np.asarray(pts, dtype=np.float64), np.asarray(wts) / 6.0


def cell_quadrature(cell_type: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature (points (nqp, dim), weights (nqp,)) on a reference cell.

    cell_type in {line, quad, tri, hex, tet}. `degree` is the cubature
    degree as in the reference's 'quadrature' input-deck key.
    """
    degree = max(int(degree), 1)
    if cell_type == "line":
        return _tensor_rule(degree // 2 + 1, 1)
    if cell_type == "quad":
        return _tensor_rule(degree // 2 + 1, 2)
    if cell_type == "hex":
        return _tensor_rule(degree // 2 + 1, 3)
    if cell_type == "tri":
        return _tri_rule(degree)
    if cell_type == "tet":
        return _tet_rule(degree)
    raise ValueError(f"unknown cell type {cell_type!r}")


def side_quadrature(cell_type: str, degree: int) -> tuple[np.ndarray, np.ndarray]:
    """Quadrature on the reference *side* cell of `cell_type`."""
    side = {"quad": "line", "tri": "line", "hex": "quad", "tet": "tri",
            "line": "point"}[cell_type]
    if side == "point":
        return np.zeros((1, 0)), np.ones(1)
    return cell_quadrature(side, degree)
