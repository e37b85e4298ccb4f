"""Solution output: Exodus (and legacy VTK) with extra cell fields.

The port of the JAX package's `mrhyde_tpu/postprocess/writer.py`
(reference PostprocessManager::writeSolution, postprocessManager.cpp:
4466): nodal solution fields, element ("Extra cell") fields from user
expressions averaged per element, and cell averages of the variables
without nodal dofs. Snapshots are taken on the host in numpy; the
Exodus file goes through mesh/exodus.py (scipy's NetCDF3).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["SolutionWriter"]


class SolutionWriter:
    def __init__(self, problem, filename: str = "output",
                 extra_cell_fields: dict | None = None):
        self.problem = problem
        self.filename = filename
        self.extra_cell_fields = extra_cell_fields or {}
        self.times: list[float] = []
        self.node_fields: dict[str, list] = {}
        self.cell_fields: dict[str, list] = {}

    def record(self, u, time: float):
        """Snapshot the nodal values of every variable and the extra cell
        fields."""
        p = self.problem
        mesh = p.mesh
        self.times.append(float(time))
        un = u.detach().cpu().numpy() if isinstance(u, torch.Tensor) \
            else np.asarray(u)
        dm = p.disc.dofmap
        for v in dm.vars:
            space = getattr(v.basis, "space", "HGRAD")
            start = dm.var_start[dm.var_index(v.name)]
            if space == "HGRAD" and v.basis.order >= 1:
                # HGRAD nodal dofs are numbered by mesh node
                vals = np.zeros(mesh.n_nodes)
                vals[:mesh.n_nodes] = un[start:start + mesh.n_nodes]
                self.node_fields.setdefault(v.name, []).append(vals)
            else:
                # the cell average for HVOL and the vector spaces
                self.cell_fields.setdefault(v.name, []).append(
                    self._cell_average(un, v.name))
        if self.extra_cell_fields:
            # user expressions averaged per element (reference: 'Extra
            # cell fields' with 'extra grp field reduction')
            from mrhyde_tpu_torch.postprocess.fields import \
                GlobalFieldContext
            ut = u.detach() if isinstance(u, torch.Tensor) \
                else torch.as_tensor(un, dtype=torch.float64)
            ctx = GlobalFieldContext(p.disc, ut, time, p.params)
            wts = np.asarray(p.disc.wts)
            for name, expr in self.extra_cell_fields.items():
                vals = torch.broadcast_to(torch.as_tensor(
                    p.fm.evaluate_expr(expr, ctx), dtype=ut.dtype,
                    device=ut.device), wts.shape).cpu().numpy()
                avg = (vals * wts).sum(axis=1) / wts.sum(axis=1)
                self.cell_fields.setdefault(name, []).append(avg)

    def _cell_average(self, u, var):
        disc = self.problem.disc
        st, nd = disc.offsets[var]
        u_e = disc.dofmap.fold(u[disc.lids][:, st:st + nd], st, nd)
        key = disc.basis_keys[var]
        wts = disc.wts
        if key[0] in ("HDIV", "HCURL"):
            vals = np.einsum("ei,eiqd->eqd", u_e, disc.vec_vals[key])
            mag = np.linalg.norm(vals, axis=2)
            return (mag * wts).sum(axis=1) / wts.sum(axis=1)
        vals = u_e @ disc.basis_vals[key]
        return (vals * wts).sum(axis=1) / wts.sum(axis=1)

    # ---- writers ----

    def write_exodus(self, path: str | None = None):
        from mrhyde_tpu_torch.mesh.exodus import write_exodus
        path = path or f"{self.filename}.exo"
        write_exodus(path, self.problem.mesh,
                     node_fields={k: np.stack(v)
                                  for k, v in self.node_fields.items()},
                     cell_fields={k: np.stack(v)
                                  for k, v in self.cell_fields.items()},
                     times=np.asarray(self.times))
        return path

    def write_vtk(self, path: str | None = None, step: int = -1):
        """Legacy-VTK snapshot of one recorded step."""
        mesh = self.problem.mesh
        path = path or f"{self.filename}.vtk"
        vtk_type = {"line": 3, "tri": 5, "quad": 9, "tet": 10,
                    "hex": 12}[mesh.cell_type]
        with open(path, "w") as f:
            f.write("# vtk DataFile Version 3.0\nmrhyde_tpu\nASCII\n"
                    "DATASET UNSTRUCTURED_GRID\n")
            f.write(f"POINTS {mesh.n_nodes} double\n")
            pts = np.zeros((mesh.n_nodes, 3))
            pts[:, :mesh.dim] = mesh.nodes
            np.savetxt(f, pts, fmt="%.10g")
            npe = mesh.conn.shape[1]
            f.write(f"CELLS {mesh.n_elem} {mesh.n_elem * (npe + 1)}\n")
            np.savetxt(f, np.column_stack([np.full(mesh.n_elem, npe),
                                           mesh.conn]), fmt="%d")
            f.write(f"CELL_TYPES {mesh.n_elem}\n")
            np.savetxt(f, np.full(mesh.n_elem, vtk_type), fmt="%d")
            if self.node_fields:
                f.write(f"POINT_DATA {mesh.n_nodes}\n")
                for name, series in self.node_fields.items():
                    f.write(f"SCALARS {name} double 1\n"
                            "LOOKUP_TABLE default\n")
                    np.savetxt(f, series[step], fmt="%.10g")
            if self.cell_fields:
                f.write(f"CELL_DATA {mesh.n_elem}\n")
                for name, series in self.cell_fields.items():
                    f.write(f"SCALARS {name} double 1\n"
                            "LOOKUP_TABLE default\n")
                    np.savetxt(f, series[step], fmt="%.10g")
        return path
