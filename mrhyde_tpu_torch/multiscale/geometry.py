"""Fine-mesh templates and per-macro-element subgrid geometry.

The port of the JAX package's `mrhyde_tpu/multiscale/geometry.py`
(reference: subgridTools.cpp buildSubGridMesh maps a template mesh into
every macro element through the macro geometric map). The template
lives in the MACRO REFERENCE cell:

- `refinements: n` on quad / hex: a 2^n uniform box refinement of
  [-1, 1]^d;
- tri / tet macro cells: the reference simplex (refinements 0);
- `mesh type: Exodus`: a template mesh read from an Exodus file,
  expressed in the macro reference cell.

Every template's boundary faces are classified by the macro face plane
that contains them: the sidesets the Dirichlet-to-Neumann coupling
integrates over, and the macro side whose trace basis each group reads.
For macro meshes that are not translation-uniform the physical fine
tables are built per macro element: the template instantiated in every
macro element as one disjoint stacked mesh, run through the
Discretization, and the tables reshaped to a leading macro axis. All of
it is host numpy, once per problem.
"""

from __future__ import annotations

import os

import numpy as np

from mrhyde_tpu_torch.fem.basis import get_basis
from mrhyde_tpu_torch.fem.topology import cell_topology
from mrhyde_tpu_torch.mesh.structured import Mesh, box_mesh

__all__ = ["fine_template", "classify_macro_sides", "build_batched_geo"]


def classify_macro_sides(mesh: Mesh, macro_cell: str):
    """Label each boundary face of a template mesh (in macro reference
    coordinates) with the macro local side it lies on.

    Returns (sidesets, side_map): sidesets {name: (B, 2) (elem, side)}
    for Mesh.sidesets, side_map {name: macro side index}."""
    topo = cell_topology(mesh.cell_type)
    mtopo = cell_topology(macro_cell)

    # boundary faces: (elem, local side) pairs whose node set is unique
    keys = {}
    for s, side_nodes in enumerate(topo.sides):
        fn = mesh.conn[:, list(side_nodes)]
        for e in range(mesh.conn.shape[0]):
            keys.setdefault(tuple(sorted(fn[e])), []).append((e, s))
    bnd = [v[0] for v in keys.values() if len(v) == 1]

    # macro face planes from the macro reference corners
    planes = []
    for side_nodes in mtopo.sides:
        C = mtopo.corners[list(side_nodes)]
        A = C[1:] - C[0]
        if A.shape[0] == 0:              # 1D: a side is a point
            n = np.ones(1)
        else:
            n = np.linalg.svd(A)[2][-1]  # the null space of A
        planes.append((C[0], n))

    sidesets, side_map = {}, {}
    for (e, s) in bnd:
        pts = mesh.nodes[mesh.conn[e, list(topo.sides[s])]]
        hit = next((ms for ms, (c0, n) in enumerate(planes)
                    if np.max(np.abs((pts - c0) @ n)) < 1e-8), None)
        if hit is None:
            raise ValueError("subgrid template boundary face not on any "
                             f"macro face (elem {e} side {s})")
        name = f"mside{hit}"
        sidesets.setdefault(name, []).append((e, s))
        side_map[name] = hit
    sidesets = {k: np.asarray(v, dtype=np.int32) for k, v in sidesets.items()}
    return sidesets, side_map


def _classified(tmpl, macro_cell):
    ss, side_map = classify_macro_sides(tmpl, macro_cell)
    tmpl.sidesets = ss
    return tmpl, side_map


def fine_template(mesh_cfg: dict, macro_cell: str, dim: int,
                  deck_dir: str = "."):
    """The template fine mesh in macro reference coordinates: (Mesh,
    side_map {sideset name: macro side index})."""
    refine = int(mesh_cfg.get("refinements", 1))
    n1 = 2 ** refine
    if str(mesh_cfg.get("mesh type", "")).lower() == "exodus":
        from mrhyde_tpu_torch.mesh.exodus import read_exodus
        path = mesh_cfg.get("mesh file", "mesh.exo")
        if not os.path.isabs(path):
            path = os.path.join(deck_dir, path)
        return _classified(read_exodus(path)[0], macro_cell)
    if macro_cell == "line":
        return _classified(box_mesh("line", nx=n1, xmin=-1.0, xmax=1.0),
                           "line")
    if macro_cell in ("quad", "hex"):
        cell = mesh_cfg.get("element type", macro_cell)
        if cell != macro_cell:
            raise NotImplementedError(
                f"subgrid template cell {cell!r} inside {macro_cell!r} "
                "(use 'mesh type: Exodus' for mixed-topology templates)")
        box = dict(nx=n1, ny=n1, xmin=-1.0, xmax=1.0, ymin=-1.0, ymax=1.0)
        if macro_cell == "hex":
            box.update(nz=n1, zmin=-1.0, zmax=1.0)
        return _classified(box_mesh(macro_cell, **box), macro_cell)
    if macro_cell in ("tri", "tet"):
        if refine != 0:
            raise NotImplementedError(
                "simplex subgrid refinement (refinements: 0 embeds the "
                "macro cell)")
        topo = cell_topology(macro_cell)
        tmpl = Mesh(dim=dim, cell_type=macro_cell,
                    nodes=np.array(topo.corners, dtype=np.float64),
                    conn=np.arange(len(topo.corners), dtype=np.int32)[None],
                    sidesets={})
        return _classified(tmpl, macro_cell)
    raise NotImplementedError(f"subgrid on {macro_cell!r} macro cells")


def build_batched_geo(sub_coords: np.ndarray, tmpl: Mesh, macro_cell: str,
                      variables, qdeg):
    """Per-macro-element physical fine geometry tables.

    sub_coords: (E, n_macro_corners, dim) macro element nodes. The
    template is mapped into every macro element (the macro HGRAD p1
    geometric map), instantiated as one disjoint stacked mesh, and the
    Discretization tables reshaped to a leading macro axis. Returns a
    tree of numpy arrays: wts (E, Ef, Q), ip (E, Ef, Q, dim), bg
    {grad / vec / div / curl: {key: (E, Ef, ...)}}, bnd [per boundary
    group: {wts, ip, normals, bg}], mass (E, Ef, ndt, ndt)."""
    from mrhyde_tpu_torch.assembly.discretization import Discretization

    gvals = get_basis(macro_cell, "HGRAD", 1).eval(tmpl.nodes)
    phys = np.einsum("ecd,cn->end", sub_coords, gvals)   # (E, nfn, dim)
    E, nfn, dim = phys.shape
    Ef, nc = tmpl.conn.shape
    conn_s = (tmpl.conn[None] + (np.arange(E) * nfn)[:, None, None])
    ss_s = {name: (ss[None] + np.array([Ef, 0])[None, None]
                   * np.arange(E)[:, None, None]).reshape(-1, 2)
            .astype(np.int32) for name, ss in tmpl.sidesets.items()}
    mesh_s = Mesh(dim=dim, cell_type=tmpl.cell_type,
                  nodes=phys.reshape(-1, dim),
                  conn=conn_s.reshape(E * Ef, nc).astype(np.int32),
                  sidesets=ss_s)
    disc_s = Discretization(mesh_s, variables,
                            None if qdeg is None else int(qdeg))

    def r(a, n=Ef):
        return np.ascontiguousarray(a.reshape((E, n) + a.shape[1:]))

    geo = {"wts": r(disc_s.wts), "ip": r(disc_s.ip),
           "bg": {name: {k: r(v) for k, v in tbl.items()}
                  for name, tbl in (("grad", disc_s.basis_grads),
                                    ("vec", disc_s.vec_vals),
                                    ("div", disc_s.div_vals),
                                    ("curl", disc_s.curl_vals))},
           "bnd": [], "mass": r(disc_s.mass_blocks())}
    for bg in disc_s.boundary_groups:
        B = bg.elems.shape[0] // E
        vec = {k: r(v[bg.elems], B) for k, v in bg.basis_vals.items()
               if k[0] in ("HDIV", "HCURL", "HDIV-DG", "HDIV_AC",
                           "HDIV_AC-DG")}
        geo["bnd"].append({
            "wts": r(bg.wts, B), "ip": r(bg.ip, B),
            "normals": r(bg.normals, B),
            "bg": {"grad": {k: r(v, B) for k, v in bg.basis_grads.items()},
                   "vec": vec, "div": {}, "curl": {}}})
    return geo
