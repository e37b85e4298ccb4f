"""Exodus II mesh and solution IO through scipy's NetCDF3 backend.

The port of the JAX package's `mrhyde_tpu/mesh/exodus.py` (reference:
meshInterface.hpp:129-147 writeToExodus, the 'source: Exodus' reader of
meshInterface.cpp). Exodus II "classic" files are NetCDF3, which
`scipy.io.netcdf_file` reads and writes; scipy is required (a missing
scipy raises ImportError). Exodus numbers nodes, elements and sides from
1 and orders the sides of a HEX8 its own way; both are translated here.

`write_exodus` writes a mesh's element blocks (elements grouped by block,
in block order), its sidesets and nodesets (the non-empty ones), and
time series of node and cell fields. `read_exodus` returns the mesh
(blocks concatenated in block order, named eblock-0, eblock-1, ...) and
the last time step of each element variable. A file either package
writes reads back the same in both.
"""

from __future__ import annotations

import numpy as np

from mrhyde_tpu_torch.mesh.structured import Mesh

__all__ = ["write_exodus", "read_exodus"]

_ELEM_TYPE = {"line": "BEAM2", "quad": "QUAD4", "tri": "TRI3",
              "hex": "HEX8", "tet": "TETRA4"}
_FROM_EXO = {"QUAD": "quad", "QUAD4": "quad", "TRI": "tri", "TRI3": "tri",
             "HEX": "hex", "HEX8": "hex", "TETRA": "tet", "TETRA4": "tet",
             "TET4": "tet", "BEAM2": "line", "BAR2": "line"}
# Exodus local side -> this package's: HEX8 Exodus sides are (0,1,5,4),
# (1,2,6,5), (2,3,7,6), (0,4,7,3), (0,3,2,1), (4,5,6,7); quad, tri and
# tet sides are in the same order in both
_SIDE_FROM_EXO = {"hex": np.array([2, 3, 4, 5, 0, 1])}


def _name_table(f, var, dimname, names):
    f.createDimension(dimname, max(len(names), 1))
    nv = f.createVariable(var, "c", (dimname, "len_string"))
    arr = np.zeros((max(len(names), 1), 33), dtype="S1")
    for i, n in enumerate(names):
        for j, ch in enumerate(n[:32]):
            arr[i, j] = ch.encode()
    nv[:] = arr


def _status(f, prefix, dimname, n):
    for var in (f"{prefix}_status", f"{prefix}_prop1"):
        v = f.createVariable(var, "i", (dimname,))
        v[:] = np.arange(1, n + 1) if var.endswith("prop1") else 1


def write_exodus(path: str, mesh: Mesh, *, node_fields: dict | None = None,
                 cell_fields: dict | None = None, times=None):
    """Write a mesh and time series of fields to an Exodus II file.

    node_fields / cell_fields: name -> (n_times, n_nodes / n_elem)
    arrays, cell fields in the mesh's element order.
    """
    from scipy.io import netcdf_file
    node_fields = node_fields or {}
    cell_fields = cell_fields or {}
    times = np.atleast_1d(np.asarray(times if times is not None else [0.0],
                                     dtype=float))
    nt = times.shape[0]
    dim = mesh.dim
    bids = (np.zeros(mesh.n_elem, dtype=np.int64)
            if mesh.block_ids is None else np.asarray(mesh.block_ids))
    blocks = [np.nonzero(bids == b)[0] for b in np.unique(bids)]
    # this package's element id -> its 0-based position in the file
    order = np.concatenate(blocks)
    pos = np.empty(mesh.n_elem, dtype=np.int64)
    pos[order] = np.arange(mesh.n_elem)

    f = netcdf_file(path, "w", version=1)
    f.title = b"mrhyde_tpu_torch"
    f.api_version = 5.22
    f.version = 5.22
    f.floating_point_word_size = 8
    f.file_size = 0
    # scipy's netcdf wants the unlimited dimension first
    f.createDimension("time_step", None)
    f.createDimension("len_string", 33)
    f.createDimension("len_line", 81)
    f.createDimension("four", 4)
    f.createDimension("num_dim", dim)
    f.createDimension("num_nodes", mesh.n_nodes)
    f.createDimension("num_elem", mesh.n_elem)
    f.createDimension("num_el_blk", len(blocks))
    tv = f.createVariable("time_whole", "d", ("time_step",))
    tv[:nt] = times
    for i, ax in enumerate("xyz"[:dim]):
        v = f.createVariable(f"coord{ax}", "d", ("num_nodes",))
        v[:] = mesh.nodes[:, i]

    _status(f, "eb", "num_el_blk", len(blocks))
    for b, elems in enumerate(blocks, start=1):
        f.createDimension(f"num_el_in_blk{b}", elems.size)
        f.createDimension(f"num_nod_per_el{b}", mesh.conn.shape[1])
        conn = f.createVariable(f"connect{b}", "i", (
            f"num_el_in_blk{b}", f"num_nod_per_el{b}"))
        conn[:] = mesh.conn[elems] + 1
        conn.elem_type = _ELEM_TYPE[mesh.cell_type].encode()

    to_exo = _SIDE_FROM_EXO.get(mesh.cell_type)
    sidesets = {k: v for k, v in mesh.sidesets.items() if len(v)}
    if sidesets:
        f.createDimension("num_side_sets", len(sidesets))
        _status(f, "ss", "num_side_sets", len(sidesets))
        _name_table(f, "ss_names", "num_ss_names", list(sidesets))
        for s, ss in enumerate(sidesets.values(), start=1):
            ss = np.asarray(ss)
            sides = ss[:, 1] if to_exo is None \
                else np.argsort(to_exo)[ss[:, 1]]
            f.createDimension(f"num_side_ss{s}", ss.shape[0])
            for var, vals in ((f"elem_ss{s}", pos[ss[:, 0]] + 1),
                              (f"side_ss{s}", sides + 1)):
                v = f.createVariable(var, "i", (f"num_side_ss{s}",))
                v[:] = vals
    nodesets = {k: v for k, v in mesh.nodesets.items() if len(v)}
    if nodesets:
        f.createDimension("num_node_sets", len(nodesets))
        _status(f, "ns", "num_node_sets", len(nodesets))
        _name_table(f, "ns_names", "num_ns_names", list(nodesets))
        for s, ns in enumerate(nodesets.values(), start=1):
            f.createDimension(f"num_nod_ns{s}", len(ns))
            v = f.createVariable(f"node_ns{s}", "i", (f"num_nod_ns{s}",))
            v[:] = np.asarray(ns) + 1

    if node_fields:
        _name_table(f, "name_nod_var", "num_nod_var", list(node_fields))
        for i, data in enumerate(node_fields.values(), start=1):
            v = f.createVariable(f"vals_nod_var{i}", "d",
                                 ("time_step", "num_nodes"))
            v[:nt] = np.asarray(data, dtype=float).reshape(nt, -1)
    if cell_fields:
        _name_table(f, "name_elem_var", "num_elem_var", list(cell_fields))
        for i, data in enumerate(cell_fields.values(), start=1):
            data = np.asarray(data, dtype=float).reshape(nt, -1)
            for b, elems in enumerate(blocks, start=1):
                v = f.createVariable(f"vals_elem_var{i}eb{b}", "d",
                                     ("time_step", f"num_el_in_blk{b}"))
                v[:nt] = data[:, elems]
    f.close()


def read_exodus(path: str) -> tuple[Mesh, dict]:
    """Read an Exodus II (NetCDF3 classic) mesh.

    Returns (Mesh, info): element blocks concatenated in block order
    with their block_ids, sidesets as (elem, local_side) pairs and
    nodesets as node ids, all 0-based in this package's side order; info
    holds "n_steps" and "elem_vars" (name -> the last step's values).
    """
    from scipy.io import netcdf_file
    f = netcdf_file(path, "r", mmap=False)
    dim = f.dimensions["num_dim"]
    coords = []
    for ax in "xyz"[:dim]:
        key = f"coord{ax}"
        if key in f.variables:
            coords.append(f.variables[key][:])
        else:  # older files hold one 'coord' variable
            coords = [f.variables["coord"][:][i] for i in range(dim)]
            break
    nodes = np.stack([np.asarray(c, dtype=float) for c in coords], axis=1)

    n_blk = f.dimensions.get("num_el_blk", 1)
    conns, block_ids, cell_type = [], [], None
    for b in range(1, n_blk + 1):
        cv = f.variables[f"connect{b}"]
        et = cv.elem_type.decode() if isinstance(cv.elem_type, bytes) \
            else str(cv.elem_type)
        ct = _FROM_EXO.get(et.upper().rstrip("0123456789")
                           + et[len(et.rstrip("0123456789")):], None)
        ct = _FROM_EXO.get(et.upper(), ct)
        if ct is None:
            raise ValueError(f"unsupported exodus elem type {et!r}")
        if cell_type is None:
            cell_type = ct
        elif cell_type != ct:
            raise NotImplementedError("mixed element types")
        c = np.asarray(cv[:], dtype=np.int64) - 1
        conns.append(c)
        block_ids.append(np.full(c.shape[0], b - 1, dtype=np.int32))
    conn = np.concatenate(conns, axis=0).astype(np.int32)
    block_ids = np.concatenate(block_ids)

    def _names(var, n, fallback):
        """Decode an Exodus char-array name table."""
        out = []
        raw = f.variables[var][:] if var in f.variables else None
        for i in range(n):
            name = ""
            if raw is not None:
                name = bytes(raw[i]).split(b"\x00")[0].decode(
                    "ascii", "ignore").strip()
            out.append(name or fallback(i))
        return out

    n_ss = f.dimensions.get("num_side_sets", 0) or 0
    ss_names = _names("ss_names", n_ss, lambda i: f"surface_{i + 1}")
    perm = _SIDE_FROM_EXO.get(cell_type)
    sidesets = {}
    for s in range(1, n_ss + 1):
        elems = np.asarray(f.variables[f"elem_ss{s}"][:]) - 1
        sides = np.asarray(f.variables[f"side_ss{s}"][:]) - 1
        if perm is not None:
            sides = perm[sides]
        sidesets[ss_names[s - 1]] = np.stack(
            [elems, sides], axis=1).astype(np.int32)

    n_ns = f.dimensions.get("num_node_sets", 0) or 0
    ns_names = _names("ns_names", n_ns, lambda i: f"nodelist_{i + 1}")
    nodesets = {}
    for s in range(1, n_ns + 1):
        nodesets[ns_names[s - 1]] = (
            np.asarray(f.variables[f"node_ns{s}"][:]) - 1).astype(np.int32)

    info = {"n_steps": (f.variables["time_whole"].shape[0]
                        if "time_whole" in f.variables else 0)}
    # element variables (reference meshInterface::readExodusData: the
    # 'have element data' decks and sensors read from the mesh)
    n_ev = f.dimensions.get("num_elem_var", 0) or 0
    if n_ev:
        ev_names = _names("name_elem_var", n_ev, lambda i: f"evar{i + 1}")
        elem_vars = {}
        for v in range(1, n_ev + 1):
            vals = []
            for b in range(1, n_blk + 1):
                key = f"vals_elem_var{v}eb{b}"
                if key in f.variables:
                    arr = np.asarray(f.variables[key][:], dtype=float)
                    vals.append(arr[-1] if arr.ndim == 2 else arr)
            if vals:
                elem_vars[ev_names[v - 1]] = np.concatenate(vals)
        info["elem_vars"] = elem_vars
    mesh = Mesh(dim=dim, cell_type=cell_type, nodes=nodes, conn=conn,
                sidesets=sidesets, block_ids=block_ids,
                block_names=[f"eblock-{b}" for b in range(n_blk)],
                nodesets=nodesets)
    f.close()
    return mesh, info
