"""Reference-cell topology tables.

These replace the Shards cell topologies the reference gets from Trilinos
(reference: src/interfaces/discretizationInterface.cpp:354-430). The
conventions here are our own; only internal consistency matters.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["cell_topology", "CellTopology"]


@dataclass(frozen=True)
class CellTopology:
    name: str
    dim: int
    corners: np.ndarray          # (n_corner, dim) reference coordinates
    edges: tuple[tuple[int, ...], ...]   # local node pairs
    sides: tuple[tuple[int, ...], ...]   # local node tuples per side
    side_cell: str               # cell type of the sides
    faces: tuple[tuple[int, ...], ...] = ()  # 3D only: quad/tri faces

    @property
    def n_corner(self) -> int:
        return self.corners.shape[0]

    @property
    def n_side(self) -> int:
        return len(self.sides)

    def side_edges(self, side: int) -> list[int]:
        """Indices (into self.edges) of edges lying on a given side."""
        sideset = set(self.sides[side])
        return [i for i, e in enumerate(self.edges) if set(e) <= sideset]


_QUAD_CORNERS = np.array([[-1, -1], [1, -1], [1, 1], [-1, 1]], dtype=np.float64)
_HEX_CORNERS = np.array(
    [[-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
     [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=np.float64)
_TRI_CORNERS = np.array([[0, 0], [1, 0], [0, 1]], dtype=np.float64)
_TET_CORNERS = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]],
                        dtype=np.float64)

_TOPO = {
    "line": CellTopology(
        name="line", dim=1,
        corners=np.array([[-1.0], [1.0]]),
        edges=((0, 1),),
        sides=((0,), (1,)),
        side_cell="point",
    ),
    "quad": CellTopology(
        name="quad", dim=2,
        corners=_QUAD_CORNERS,
        edges=((0, 1), (1, 2), (2, 3), (3, 0)),
        sides=((0, 1), (1, 2), (2, 3), (3, 0)),
        side_cell="line",
    ),
    "tri": CellTopology(
        name="tri", dim=2,
        corners=_TRI_CORNERS,
        edges=((0, 1), (1, 2), (2, 0)),
        sides=((0, 1), (1, 2), (2, 0)),
        side_cell="line",
    ),
    "hex": CellTopology(
        name="hex", dim=3,
        corners=_HEX_CORNERS,
        edges=((0, 1), (1, 2), (2, 3), (3, 0),
               (4, 5), (5, 6), (6, 7), (7, 4),
               (0, 4), (1, 5), (2, 6), (3, 7)),
        sides=((0, 3, 2, 1), (4, 5, 6, 7),
               (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (0, 4, 7, 3)),
        side_cell="quad",
        faces=((0, 3, 2, 1), (4, 5, 6, 7),
               (0, 1, 5, 4), (1, 2, 6, 5), (2, 3, 7, 6), (0, 4, 7, 3)),
    ),
    "tet": CellTopology(
        name="tet", dim=3,
        corners=_TET_CORNERS,
        edges=((0, 1), (1, 2), (2, 0), (0, 3), (1, 3), (2, 3)),
        sides=((0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)),
        side_cell="tri",
        faces=((0, 1, 3), (1, 2, 3), (0, 3, 2), (0, 2, 1)),
    ),
}


def cell_topology(cell_type: str) -> CellTopology:
    try:
        return _TOPO[cell_type]
    except KeyError:
        raise ValueError(f"unknown cell type {cell_type!r}") from None
