"""Problem: wires config -> mesh -> physics -> assembly -> solve -> report.

The port of the JAX package's `mrhyde_tpu/problem.py` (reference
driver.cpp:62-212, SolverManager::steadySolver and transientSolver,
AnalysisManager::run): initial conditions by L2 projection or
interpolation, the steady Newton solve and the transient integrator,
the postprocessing (solution storage, the Exodus writer, objectives,
integrated quantities), discretized (field) parameters, and the
analysis modes through `run()`, and the sharded Newton solves of
`Solver: shards` (parallel/). `make_problem` gives a multi-set deck its
MultiSetProblem. The config is the same nested dict as the reference
input deck.
"""

from __future__ import annotations

import itertools
import os
from dataclasses import dataclass, field

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import (Assembler, PointContext,
                                                 TimeCoeffs)
from mrhyde_tpu_torch.assembly.discretization import Discretization
from mrhyde_tpu_torch.functions.manager import FunctionManager
from mrhyde_tpu_torch.mesh.structured import box_mesh
from mrhyde_tpu_torch.physics.registry import import_physics
from mrhyde_tpu_torch.postprocess.errors import ErrorCalculator
from mrhyde_tpu_torch.runtime import resolve_device, resolve_dtype
from mrhyde_tpu_torch.solvers.bcs import BoundaryConditions
from mrhyde_tpu_torch.solvers.linear import solve_linear
from mrhyde_tpu_torch.solvers.nonlinear import newton_solve
from mrhyde_tpu_torch.solvers.time_integration import TransientIntegrator
from mrhyde_tpu_torch.utils import profiling
from mrhyde_tpu_torch.utils.profiling import timed

__all__ = ["Problem", "ForwardResult", "make_problem"]

# the ordinal of a forward, in its profiler range: mrhyde::forward#<n>
_FORWARDS = itertools.count(1)


def make_problem(cfg: dict, device=None, dtype=None, comm=None):
    """The problem of a deck: a MultiSetProblem for a multi-set deck
    ('physics set names'), else a Problem (whose sharded Newton solves
    run over `comm`, when given)."""
    if "physics set names" in (cfg.get("Physics", {}) or {}):
        from mrhyde_tpu_torch.multiset import MultiSetProblem
        return MultiSetProblem(cfg, device=device, dtype=dtype)
    return Problem(cfg, device=device, dtype=dtype, comm=comm)


@dataclass
class ForwardResult:
    u: object
    time: float
    error_history: list = field(default_factory=list)
    solution_history: list = field(default_factory=list)
    newton: object = None           # NewtonResult of a steady solve
    # stage solves, Newton and Krylov iterations over the whole run
    # and the host syncs of the forward (utils/profiling.host_value)
    counts: dict = field(default_factory=dict)

    @property
    def errors(self):
        """Errors at the final recorded time."""
        return self.error_history[-1][1] if self.error_history else {}

    def report(self) -> str:
        return ErrorCalculator.format_report(self.error_history)


class Problem:
    def __init__(self, cfg: dict, device=None, dtype=None, mesh=None,
                 comm=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.dtype = resolve_dtype(dtype)
        mesh_cfg = cfg.get("Mesh", {}) or {}
        dim = int(mesh_cfg.get("dimension", 2))
        cell = mesh_cfg.get("element type", mesh_cfg.get("shape", "quad"))
        cell = {"interval": "line", "quadrilateral": "quad",
                "triangle": "tri", "hexahedron": "hex",
                "tetrahedron": "tet"}.get(cell, cell)
        if dim == 1:
            cell = "line"
        with timed("problem::mesh"):
            self._setup_mesh(cfg, mesh_cfg, cell, mesh)

        raw_phys = cfg.get("Physics", {}) or {}
        phys_cfg = _unwrap_block(raw_phys, "modules")
        self.phys_cfg = phys_cfg
        # per-block physics (reference physicsInterface.cpp:38-54: each
        # element block owns its module list): several block sublists
        # naming different modules
        block_sub = {k: v for k, v in raw_phys.items()
                     if isinstance(v, dict) and "modules" in v}
        bnames = list(getattr(self.mesh, "block_names", []))
        self._module_block = None
        if (len(block_sub) > 1 and all(k in bnames for k in block_sub)
                and len({str(v.get("modules"))
                         for v in block_sub.values()}) > 1):
            self.modules, self._module_block = [], []
            shared = {k: v for k, v in raw_phys.items()
                      if not isinstance(v, dict) or "modules" not in v}
            for bi, bn in enumerate(bnames):
                sub = block_sub.get(bn)
                if sub is None:
                    continue
                for m in import_physics(sub.get("modules", ""),
                                        dict(shared, **sub), dim):
                    self.modules.append(m)
                    self._module_block.append(bi)
        else:
            self.modules = import_physics(phys_cfg.get("modules", ""),
                                          phys_cfg, dim)

        disc_cfg = _unwrap_block(cfg.get("Discretization", {}), "order")
        orders = disc_cfg.get("order", {}) or {}
        # 'Active variables' restricts the modules' variables to those
        # it lists (reference porousMixed.cpp:21-30) and may override a
        # variable's space (an HGRAD-DG pressure, an HFACE trace)
        active = phys_cfg.get("Active variables", {}) or {}
        variables = []
        seen = set()
        for m in self.modules:
            for (name, space, default_order) in m.variables():
                if name in seen:
                    continue
                seen.add(name)
                if active and name not in active:
                    continue
                space = active.get(name, space)
                order = int(orders.get(name, default_order))
                if space == "HVOL":
                    # the reference's HVOL is always piecewise constant,
                    # whatever order the deck gives
                    order = 0
                variables.append((name, space, max(order, 0)
                                  if space in ("HVOL", "HFACE")
                                  else max(order, 1)))
        # 'Extra variables': name -> space, orders under the order
        # sublist's own 'Extra variables' (else the variable's, else 1)
        extra_orders = orders.get("Extra variables", {}) or {}
        for name, space in (phys_cfg.get("Extra variables", {})
                            or {}).items():
            variables.append((name, space, int(extra_orders.get(
                name, orders.get(name, 1)))))
        if not variables:
            raise ValueError("no variables: the Physics sublist needs "
                             "'modules' (or 'Extra variables')")
        self.variables = variables

        # functions; per-block sublists flatten. The reference keeps one
        # function manager per block; one physics set holds one
        # definition of each name, so a name defined differently across
        # blocks raises, as in the JAX package
        self.fm = FunctionManager()
        fs = {}
        for name, expr in (cfg.get("Functions", {}) or {}).items():
            if isinstance(expr, dict):
                for k, v in expr.items():
                    if k in fs and str(fs[k]) != str(v):
                        raise NotImplementedError(
                            f"per-block Functions define {k!r} "
                            f"differently across blocks ({fs[k]!r} vs "
                            f"{v!r}); per-block function expressions are "
                            "not supported in one physics set")
                fs.update(expr)
            else:
                fs[name] = expr
        for name, expr in fs.items():
            self.fm.add_function(name, expr, "ip")
            self.fm.add_function(name, expr, "side ip")
        for m in self.modules:
            m.define_functions(self.fm, fs)
        # the Parameters sublist: scalar and vector parameters resolve as
        # expression leaves (a function of the same name comes first)
        from mrhyde_tpu_torch.analysis.parameters import ParameterManager
        self.param_manager = ParameterManager(cfg.get("Parameters"))
        self.params = self.param_manager.all_values(self.device,
                                                    self.dtype)

        qdeg = disc_cfg.get("quadrature")
        sqdeg = disc_cfg.get("side quadrature")
        with timed("problem::discretization"):
            self.disc = Discretization(self.mesh, variables,
                                       None if qdeg is None else int(qdeg),
                                       None if sqdeg is None
                                       else int(sqdeg))
        with timed("problem::boundary_conditions"):
            self.bcs = BoundaryConditions.from_config(
                self.disc, self.fm, phys_cfg, self.params,
                use_weak_dirichlet=bool(phys_cfg.get("use weak Dirichlet",
                                                     False)))
        # 'assemble face terms' (reference: physicsInterface reads it per
        # set or block; assemblyManager.cpp:2414-2425 runs the per-side
        # faceResidual sweep): default on iff a module defines face terms
        aft = phys_cfg.get("assemble face terms",
                           phys_cfg.get("build face terms"))
        with timed("problem::assembler"):
            self._setup_assembler(cfg, mesh_cfg, dim, aft, comm)
        # build the fused provider now: a deck it would have to refuse
        # (a coupling or coefficient not ported yet) raises here
        with timed("problem::fused_provider"):
            self.assembler.fused_provider()

        with timed("problem::postprocess"):
            pp_cfg = _unwrap_block(cfg.get("Postprocess", {}) or {},
                                   "True solutions")
            self.compute_errors = bool(pp_cfg.get("compute errors", False))
            self.error_calc = ErrorCalculator(
                self.disc, self.fm, pp_cfg.get("True solutions", {}) or {},
                self.params, device=self.device, dtype=self.dtype)
            self._setup_postprocess(pp_cfg, phys_cfg)

    def _setup_mesh(self, cfg, mesh_cfg, cell, mesh):
        """The mesh: the given one, an Exodus file's or the inline box
        mesh, with its periodic pairs."""
        if mesh is not None:
            self.mesh = mesh
        elif str(mesh_cfg.get("source", mesh_cfg.get(
                "Source", "Internal"))).lower() == "exodus":
            from mrhyde_tpu_torch.mesh.exodus import read_exodus
            path = mesh_cfg.get("mesh file", "mesh.exo")
            if not os.path.isabs(path):
                path = os.path.join(cfg.get("_deck_dir", "."), path)
            self.mesh, minfo = read_exodus(path)
            self.mesh_elem_vars = minfo.get("elem_vars", {})
        else:
            self.mesh = self._internal_mesh(mesh_cfg, cell)
        pbc = mesh_cfg.get("Periodic BCs", {}) or {}
        conds = [v for k, v in pbc.items()
                 if str(k).lower().startswith("periodic condition")]
        if conds:
            from mrhyde_tpu_torch.mesh.structured import apply_periodic
            self.mesh = apply_periodic(self.mesh, conds)

    def _setup_assembler(self, cfg, mesh_cfg, dim, aft, comm):
        """The assembler with the mesh data, per-block module masks,
        the solver settings, sharding, discretized parameters and the
        subgrid models."""
        self.assembler = Assembler(self.disc, self.modules, self.fm,
                                   self.params,
                                   fixed_dofs=self.bcs.fixed_dofs,
                                   dtype=self.dtype, device=self.device,
                                   assemble_face_terms=aft)
        self._import_mesh_data(mesh_cfg, dim)
        if self._module_block is not None:
            bids = np.asarray(self.mesh.block_ids)
            self.assembler.set_module_masks(np.stack(
                [(bids == b).astype(float) for b in self._module_block],
                axis=1))
        self.assembler.var_bcs = self.bcs.var_bcs
        self.assembler.is_transient = (
            (cfg.get("Solver", {}) or {}).get("solver") == "transient")
        self.solver_cfg = cfg.get("Solver", {}) or {}
        # deck-level sharding (Solver: shards, the CLI's --shards,
        # MRHYDE_SHARDS): the Newton solves run sharded over `comm`
        # (parallel/comm.py; a StackedComm of that many shards when the
        # caller gives none), the mpiexec -n N analog
        self.comm = comm
        self.shards = int(self.solver_cfg.get(
            "shards", os.environ.get("MRHYDE_SHARDS", 0)) or 0)
        if comm is not None and self.shards <= 1:
            self.shards = comm.n_shards
        self._sharded_newton = None
        self._setup_field_params()
        self._setup_multiscale(cfg)

    def _setup_multiscale(self, cfg):
        """The Subgrid sublist's models (JAX `problem.py:387-403`): one
        SubgridDtN, or MultiscaleModels for several model sublists with
        usage expressions. Every macro element gets a subgrid model (the
        reference's winner defaults even with zero votes,
        assemblyManager.cpp:8101-8108), so the upscaled flux REPLACES the
        macro volume terms everywhere."""
        self.multiscale = None
        if not cfg.get("Subgrid"):
            return
        from mrhyde_tpu_torch.multiscale.subgrid import (MultiscaleModels,
                                                         SubgridDtN)
        sub = cfg["Subgrid"].get("Subgrid", cfg["Subgrid"])
        self.multiscale = SubgridDtN(self, sub) if "Mesh" in sub \
            else MultiscaleModels(self, sub)
        self.assembler.multiscale = self.multiscale
        self.assembler.volume_off = True

    def _setup_postprocess(self, pp_cfg, phys_cfg):
        """The writer, the solution storage, the objectives and the
        integrated quantities of the Postprocess sublist (JAX
        `problem.py:279-335`)."""
        self.write_solution = bool(pp_cfg.get("write solution", False))
        self.output_file = pp_cfg.get("output file", "output")
        self.extra_cell_fields = pp_cfg.get("Extra cell fields", {}) or {}
        self.solution_writer = None
        if self.write_solution:
            from mrhyde_tpu_torch.postprocess.writer import SolutionWriter
            self.solution_writer = SolutionWriter(
                self, self.output_file, self.extra_cell_fields)
        from mrhyde_tpu_torch.postprocess.storage import SolutionStorage
        self.solution_storage = SolutionStorage(
            max_storage=int(self.solver_cfg.get("maximum storage", 100)),
            time_tol=float(self.solver_cfg.get("storage time tol", 1e-10)))

        self.objective_manager = None
        obj_cfg = self._resolve_mesh_sensors(
            pp_cfg.get("Objective functions", {}) or {})
        if not obj_cfg and bool(pp_cfg.get("compute objective", False)):
            # the legacy Physics-level Responses / Targets / Weights
            # objective (old 'response type: global' decks): J = sum_r
            # int 0.5 wt (resp - targ)^2, entries zipped in order
            targs = list((phys_cfg.get("Targets", {}) or {}).values())
            wghts = list((phys_cfg.get("Weights", {}) or {}).values())
            for i, (rn, rexpr) in enumerate(
                    (phys_cfg.get("Responses", {}) or {}).items()):
                tg = targs[i] if i < len(targs) else "0.0"
                w = wghts[i] if i < len(wghts) else "1.0"
                obj_cfg[rn] = {
                    "type": "integrated control",
                    "function": (f"0.5*({w})*(({rexpr})-({tg}))"
                                 f"*(({rexpr})-({tg}))")}
        if obj_cfg:
            from mrhyde_tpu_torch.postprocess.objectives import (
                ObjectiveManager, ObjectiveSpec)
            self.objective_manager = ObjectiveManager(
                self.disc, self.fm,
                [ObjectiveSpec.from_config(name, sub)
                 for name, sub in obj_cfg.items()], self.params,
                n_ranks=pp_cfg.get("integrated response ranks", 4))
            self.objective_manager.field_params = \
                self.assembler.field_params

        self.integrated_quantities = None
        if pp_cfg.get("compute integrated quantities", False):
            from mrhyde_tpu_torch.postprocess.quantities import \
                IntegratedQuantities
            self.integrated_quantities = IntegratedQuantities.from_problem(
                self, pp_cfg.get("Integrated quantities", {}) or {})

    def _setup_field_params(self):
        """Each discretized parameter's own DOF map on this mesh and its
        tables at the volume qps, in the assembler's field-parameter
        registry (reference parameterManager.cpp:272
        setupDiscretizedParameters; JAX `problem.py:336-385`). A
        scalar start value fills the field; a dynamic parameter holds
        one field per time step."""
        from mrhyde_tpu_torch.fem.basis import get_basis
        from mrhyde_tpu_torch.fem.dofmap import build_dofmap
        from mrhyde_tpu_torch.fem.geometry import (physical_grad,
                                                   volume_geometry)
        pm = self.param_manager
        disc = self.disc

        def t(a, dtype=None):
            return torch.as_tensor(np.asarray(a), dtype=dtype or self.dtype,
                                   device=self.device)
        for name in pm.discretized_names():
            s = pm.specs[name]
            dm = build_dofmap(self.mesh, [(name, s.basis, s.order)])
            b = get_basis(self.mesh.cell_type, s.basis, s.order)
            key = (str(s.basis).upper(), int(s.order))
            if key in disc.basis_grads:
                gphi = disc.basis_grads[key]
            else:
                vol = volume_geometry(self.mesh.nodes[self.mesh.conn],
                                      self.mesh.cell_type, disc.ref_pts,
                                      disc.ref_wts)
                gphi = physical_grad(b, disc.ref_pts, vol.jac_inv)
            val = np.asarray(s.value, dtype=float)
            n_dof = dm.vars[0].n_dof
            if val.size != n_dof:
                s.value = np.full(n_dof, float(val.flat[0]))
            if s.dynamic:
                # one field per time step (reference dynamic_Psol,
                # parameterManager.cpp:620-632), the step count as the
                # transient driver takes it
                sc = self.solver_cfg
                t0 = float(sc.get("initial time", 0.0))
                t_end = float(sc.get("final time", 1.0))
                dts = sc.get("delta t")
                nst = max(int(round((t_end - t0) / float(dts))), 1) \
                    if dts is not None else int(sc.get("number of steps", 1))
                v = np.atleast_1d(np.asarray(s.value, dtype=float))
                if v.ndim == 1:
                    s.value = np.tile(v[None, :], (nst, 1))
            self.assembler.field_params[name] = {
                "eldofs": t(dm.vars[0].eldofs, torch.int64),
                "phi": t(b.eval(disc.ref_pts)),
                "gphi": t(gphi),
                "key": key,
                "dof_coords": dm.vars[0].dof_coords,
                "n_dof": n_dof,
                "value": s.value,
            }

    def _resolve_mesh_sensors(self, obj_cfg):
        """'sensor points file: mesh': the sensor locations and data come
        from Exodus ELEMENT variables (numSensors, sensor_<j>_Loc_*, and
        the field named by 'sensor data file'; reference
        importSensorsFromExodus, postprocessManager.cpp:5397-5470; steady
        data at time 0)."""
        ev = getattr(self, "mesh_elem_vars", None) or {}
        out = {}
        for name, sub in obj_cfg.items():
            if (isinstance(sub, dict)
                    and str(sub.get("sensor points file", "")) == "mesh"):
                sub = dict(sub)
                if "numSensors" not in ev:
                    raise ValueError(
                        "'sensor points file: mesh' requires a "
                        "'numSensors' element variable in the Exodus "
                        f"mesh (found: {sorted(ev) or 'none'})")
                ns = np.asarray(ev["numSensors"], dtype=int)
                dfield = str(sub.pop("sensor data file", ""))
                if dfield not in ev:
                    raise ValueError(
                        f"sensor data field {dfield!r} not among the "
                        f"mesh element variables {sorted(ev)}")
                sub.pop("sensor points file")
                pts, data = [], []
                for e in np.nonzero(ns > 0)[0]:
                    for j in range(int(ns[e])):
                        pts.append([float(ev[f"sensor_{j + 1}_Loc_{a}"][e])
                                    for a in "xyz"[:self.mesh.dim]])
                        data.append(float(ev[dfield][e]))
                sub["sensor points"] = pts
                sub["sensor times"] = [0.0]
                sub["sensor data"] = [[d] for d in data]
            out[name] = sub
        return out

    def _with_fields(self, pvec):
        """pvec with every discretized parameter it lacks at its current
        value, on the problem's device."""
        pm = self.param_manager
        out = dict(pvec or {})
        for name in pm.discretized_names():
            if name not in out:
                out[name] = torch.as_tensor(
                    np.asarray(pm.specs[name].value, dtype=float),
                    dtype=self.dtype, device=self.device)
        return out or None

    def _errors(self, u, time):
        """The deck's error norms at u, the subgrid models' beside."""
        errs = self.error_calc.compute(u, time)
        if self.multiscale is not None:
            errs.update(self.multiscale.compute_errors(u, time))
        return errs

    def _record(self, u, time):
        self.solution_storage.store(u, time)
        if self.solution_writer is not None:
            self.solution_writer.record(u, time)

    def _import_mesh_data(self, mesh_cfg, dim):
        """'data file' (reference importMeshData): each element center
        takes the row of the closest data point. With 'have mesh data
        rotations' a row is a grain's 3x3 rotation, and each crystal
        elasticity module's stiffness is rotated per element into the
        extra field "crystal_C" (reference CrystalElasticity.cpp:412-450);
        otherwise column 0 is the extra field "mesh_data"."""
        data_tag = str(mesh_cfg.get("data file", "none"))
        if data_tag == "none":
            return
        from mrhyde_tpu_torch.native import nearest_point
        base = self.cfg.get("_deck_dir", ".")
        pts_tag = str(mesh_cfg.get("data points file", "mesh_data_pts"))
        pts = np.loadtxt(os.path.join(base, pts_tag + ".dat"), ndmin=2)
        vals = np.loadtxt(os.path.join(base, data_tag + ".dat"), ndmin=2)
        cents = self.mesh.nodes[self.mesh.conn].mean(axis=1)
        nearest = nearest_point(pts[:, :dim], cents)
        fields = self.assembler.extra_elem_fields
        if not mesh_cfg.get("have mesh data rotations", False):
            fields["mesh_data"] = torch.as_tensor(
                vals[nearest, 0], dtype=self.dtype, device=self.device)
            return
        from mrhyde_tpu_torch.physics.crystal_elasticity import (
            CrystalElasticity)
        R = vals[nearest].reshape(-1, 3, 3)[:, :dim, :dim]
        for m in self.modules:
            if isinstance(m, CrystalElasticity):
                Ce = np.einsum("eia,ejb,ekc,eld,abcd->eijkl", R, R, R, R,
                               m.C_ref)
                fields["crystal_C"] = torch.as_tensor(
                    Ce.reshape(Ce.shape[0], -1), dtype=self.dtype,
                    device=self.device)

    @staticmethod
    def _internal_mesh(mesh_cfg, cell):
        # NX is elements per block in each direction (Panzer inline-mesh
        # convention, reference meshInterface.cpp:138-139)
        xb = int(mesh_cfg.get("Xblocks", 1))
        yb = int(mesh_cfg.get("Yblocks", 1))
        zb = int(mesh_cfg.get("Zblocks", 1))
        mesh = box_mesh(
            cell,
            nx=int(mesh_cfg.get("NX", 1)) * xb,
            ny=int(mesh_cfg.get("NY", 1)) * yb,
            nz=int(mesh_cfg.get("NZ", 1)) * zb,
            xmin=float(mesh_cfg.get("xmin", 0.0)),
            xmax=float(mesh_cfg.get("xmax", 1.0)),
            ymin=float(mesh_cfg.get("ymin", 0.0)),
            ymax=float(mesh_cfg.get("ymax", 1.0)),
            zmin=float(mesh_cfg.get("zmin", 0.0)),
            zmax=float(mesh_cfg.get("zmax", 1.0)))
        if xb * yb * zb > 1 and cell in ("quad", "hex"):
            # Panzer's eblock-i_j(_k) element-block labels
            cents = mesh.nodes[mesh.conn].mean(axis=1)
            nbs = (xb, yb, zb)
            idx = []
            for d, (lo, hi, _n) in enumerate(mesh.box_info["bounds"]):
                bw = (hi - lo) / nbs[d]
                idx.append(np.clip(((cents[:, d] - lo) / bw).astype(int),
                                   0, nbs[d] - 1))
            if len(idx) == 2:
                mesh.block_ids = idx[0] + xb * idx[1]
                mesh.block_names = [f"eblock-{i}_{j}" for j in range(yb)
                                    for i in range(xb)]
            else:
                mesh.block_ids = idx[0] + xb * idx[1] + xb * yb * idx[2]
                mesh.block_names = [f"eblock-{i}_{j}_{k}"
                                    for k in range(zb) for j in range(yb)
                                    for i in range(xb)]
        return mesh

    @property
    def n_dof(self):
        return self.disc.n_dof

    @timed("forward::initial_state")
    def initial_state(self, time=0.0):
        """Initial condition by L2 projection (the reference default,
        SolverManager::setInitial) or nodal interpolation, with the
        strong Dirichlet values written in; zero where the deck gives
        none."""
        ics = {k: v for k, v in (self.phys_cfg.get(
            "Initial conditions", {}) or {}).items() if k != "scalar data"}
        for m in self.modules:
            if hasattr(m, "augment_initial_conditions"):
                m.augment_initial_conditions(ics)
        # keys may be components ('E[x]'); a module-augmented trace IC
        # may name a variable 'Active variables' left out
        ics = {k: v for k, v in ics.items()
               if k.split("[")[0] in self.disc.dofmap.offsets}
        ic_type = self.solver_cfg.get("initial type", "L2-projection")
        u = torch.zeros(self.n_dof, dtype=self.dtype, device=self.device)
        if ics and ic_type.startswith("L2-projection"):
            with timed("initial_state::mass"):
                M = self.assembler.mass_jacobian()
            with timed("initial_state::rhs"):
                b = self.assembler.l2_rhs(ics, time=time)
            with timed("initial_state::solve"):
                u = solve_linear(M, b, method=self._proj_method())
        elif ics:
            for var, expr in ics.items():
                vdm = self.disc.dofmap.var(var)
                gdofs = torch.as_tensor(self.disc.dofmap.all_dofs(var),
                                        device=self.device)
                ctx = PointContext(
                    torch.as_tensor(vdm.dof_coords, dtype=self.dtype,
                                    device=self.device), time, self.params)
                u[gdofs] = torch.broadcast_to(torch.as_tensor(
                    self.fm.evaluate_expr(expr, ctx), dtype=self.dtype,
                    device=self.device), gdofs.shape)
        return self.bcs.apply(u, time)

    def _proj_method(self):
        return "direct" if self.n_dof <= 6000 else "cg"

    def _linear_method(self):
        if bool(self.solver_cfg.get("use direct solver", False)):
            return "direct"
        belos = str(self.solver_cfg.get("Belos solver", "")).lower()
        if belos:
            # the reference's Belos catalog onto the native Krylov set
            if "bicgstab" in belos or "tfqmr" in belos:
                return "bicgstab"
            if belos.endswith("cg") or "pcpg" in belos:
                return "cg"
            return "gmres"
        if self.n_dof <= 4000 and "preconditioner variant" \
                not in self.solver_cfg:
            return "direct"
        return "gmres"

    def _precond_variant(self):
        if not bool(self.solver_cfg.get("use preconditioner", True)):
            return "none"
        if "preconditioner variant" in self.solver_cfg:
            return str(self.solver_cfg["preconditioner variant"])
        ps = self.solver_cfg.get("Preconditioner Settings", {}) or {}
        sm = str(ps.get("smoother: type", "")).upper()
        if sm.startswith("ILU"):
            return "multigrid"
        if sm == "CHEBYSHEV":
            return "chebyshev"
        if sm == "SCHWARZ":
            return "schwarz"
        return "jacobi"

    def _newton_fn(self):
        """newton_solve, or its sharded drop-in when shards > 1:
        DOF-sharded (the v2 halo scheme) for every deck, multiscale decks
        composing both parallelism axes (macro DOFs sharded with halo
        rings, the fine DtN solves outside the sharded step); `sharded
        scheme: replicated` takes a multiscale deck through the v1
        element-sharded scheme. On a mesh too small for the +-1 halo ring
        the shard count halves until the partition is valid, and a line
        says so (JAX `problem.py:580-625`); 1 shard is the ordinary
        newton_solve. A given communicator's shard count cannot change:
        such a mesh raises."""
        if self.shards <= 1:
            return newton_solve
        if self._sharded_newton is None:
            from mrhyde_tpu_torch.parallel.deck_sharded import (
                ReplicatedShardedNewton, ShardedNewton)
            from mrhyde_tpu_torch.parallel.sharding import make_comm
            scheme = str(self.solver_cfg.get("sharded scheme", "dof"))
            cls = (ReplicatedShardedNewton
                   if (scheme == "replicated"
                       and self.assembler.multiscale is not None)
                   else ShardedNewton)
            shards = self.shards
            while True:
                comm = self.comm
                if comm is None:
                    comm = make_comm(shards)
                elif comm.n_shards != shards:
                    raise ValueError(
                        f"the mesh needs {shards} shards or fewer for the "
                        f"halo ring; the communicator holds "
                        f"{comm.n_shards}")
                try:
                    self._sharded_newton = cls(
                        self.assembler, comm,
                        cg_iters=int(self.solver_cfg.get(
                            "max linear iters", 200)),
                        gmres_m=int(self.solver_cfg.get(
                            "gmres restart length", 60)),
                        gmres_restarts=int(self.solver_cfg.get(
                            "linear solver restarts", 4)))
                    break
                except ValueError as e:
                    if "non-neighbor shards" not in str(e):
                        raise
                    shards //= 2
                    print(f"[mrhyde] mesh too small for the halo ring "
                          f"at {shards * 2} shards; using {shards}")
                    if shards <= 1 and self.comm is None:
                        self.shards = 1
                        return newton_solve
        return self._sharded_newton

    def solve_steady(self, record=True, pvec=None, u0=None) -> ForwardResult:
        u0 = self.initial_state() if u0 is None else u0
        pvec = self._with_fields(pvec)
        tc = TimeCoeffs.steady(self.n_dof, dtype=self.dtype,
                               device=self.device)
        sc = self.solver_cfg
        result = self._newton_fn()(
            self.assembler, u0, tc, pvec,
            tol=float(sc.get("nonlinear TOL", 1e-6)),
            abstol=float(sc.get("absolute nonlinear TOL", 1e-100)),
            maxiter=int(sc.get("max nonlinear iters", 10)),
            linear_method=self._linear_method(),
            linear_tol=float(sc.get("linear TOL", 1e-12)),
            precond_variant=self._precond_variant(),
            backtracking=bool(sc.get("allow backtracking", True)))
        out = ForwardResult(u=result.u, time=0.0, newton=result,
                            counts={"stages": 1,
                                    "newton_iters": result.iterations,
                                    "linear_iters": result.linear_iters})
        if not record:
            return out
        with timed("forward::record"):
            if self.compute_errors:
                out.error_history.append((0.0,
                                          self._errors(result.u, 0.0)))
            if self.integrated_quantities is not None:
                out.integrated = self.integrated_quantities.compute(
                    result.u, 0.0)
            self._record(result.u, 0.0)
            if self.solution_writer is not None:
                self.solution_writer.write_exodus()
        return out

    def solve_transient(self, record=True, pvec=None,
                        u0=None) -> ForwardResult:
        sc = self.solver_cfg
        t0 = float(sc.get("initial time", 0.0))
        t_end = float(sc.get("final time", 1.0))
        nsteps = int(sc.get("number of steps", 1))
        dt = sc.get("delta t")
        dt = float(dt) if dt is not None else (t_end - t0) / nsteps

        custom = None
        if sc.get("transient Butcher tableau") == "custom":
            custom = (_parse_matrix(sc.get("transient Butcher A", "1.0")),
                      _parse_vector(sc.get("transient Butcher b", "1.0")),
                      _parse_vector(sc.get("transient Butcher c", "1.0")))

        # the reference's defaults: the startup tableau defaults to the
        # MAIN tableau, the startup BDF order to the main BDF order, and
        # the startup STEPS to the BDF order, so a plain 'transient BDF
        # order: 2' deck self-starts with BDF-2 on a history tiled from u0
        tab = sc.get("transient Butcher tableau", "BWE")
        bdf = int(sc.get("transient BDF order", 1))
        integ = TransientIntegrator(
            assembler=self.assembler,
            newton_fn=None if self.shards <= 1 else self._newton_fn(),
            tableau=tab,
            bdf_order=bdf,
            startup_tableau=sc.get("transient startup Butcher tableau",
                                   tab),
            startup_bdf_order=int(
                sc.get("transient startup BDF order", bdf)),
            startup_steps=int(sc.get("transient startup steps", bdf)),
            custom_tableau=custom,
            nonlinear_tol=float(sc.get("nonlinear TOL", 1e-6)),
            abs_tol=float(sc.get("absolute nonlinear TOL", 1e-100)),
            max_nonlinear_iters=int(sc.get("max nonlinear iters", 10)),
            linear_method=self._linear_method(),
            linear_tol=float(sc.get("linear TOL", 1e-12)),
            precond_variant=self._precond_variant(),
            max_cuts=int(sc.get("maximum time step cuts", 5)),
            backtracking=bool(sc.get("allow backtracking", True)),
            set_dirichlet=self.bcs.apply, pvec=self._with_fields(pvec),
            dynamic_params=tuple(
                n for n in self.param_manager.discretized_names()
                if self.param_manager.specs[n].dynamic),
            fully_explicit=bool(sc.get("fully explicit", False)),
            lump_mass=bool(sc.get("lump mass", True)),
            mass_cg_iters=int(sc.get("max linear iters", 100)),
            mass_cg_tol=float(sc.get("linear TOL", 1e-2)))

        out = ForwardResult(u=None, time=t0)
        if self.multiscale is not None:
            self.multiscale.init_history(integ.max_history(), self.dtype,
                                         t0=t0)

        def observer(u, time, step):
            if not record:
                return
            with timed("forward::record"):
                if self.compute_errors:
                    out.error_history.append((time, self._errors(u, time)))
                self._record(u, time)

        u0 = self.initial_state(time=t0) if u0 is None else u0
        out.u, out.time = integ.run(u0, t0=t0, t_end=t_end, dt=dt,
                                    num_steps=nsteps, observer=observer)
        out.counts = dict(integ.counts)
        if record and self.solution_writer is not None:
            with timed("forward::record"):
                self.solution_writer.write_exodus()
        return out

    def forward(self, pvec=None, u0=None) -> ForwardResult:
        """A steady solve or a transient run from the deck's initial
        state (or u0), with its host syncs in `counts`."""
        syncs = profiling.counter("host_syncs")
        with timed("forward", f"forward#{next(_FORWARDS)}"):
            if self.solver_cfg.get("solver", "steady-state") == "transient":
                out = self.solve_transient(pvec=pvec, u0=u0)
            else:
                out = self.solve_steady(pvec=pvec, u0=u0)
        out.counts["host_syncs"] = profiling.counter("host_syncs") - syncs
        return out

    def run(self):
        analysis = (self.cfg.get("Analysis", {}) or {}).get(
            "analysis type", "forward")
        if analysis == "forward":
            return self.forward()
        from mrhyde_tpu_torch.analysis.manager import AnalysisManager
        return AnalysisManager(self).run()


def _unwrap_block(cfg: dict, marker: str) -> dict:
    """Flatten a per-block sublist ({'eblock-0_0': {...}}) if present."""
    cfg = cfg or {}
    if marker in cfg:
        return cfg
    for v in cfg.values():
        if isinstance(v, dict) and marker in v:
            merged = {k: val for k, val in cfg.items()
                      if not isinstance(val, dict) or marker not in val}
            merged.update(v)
            return merged
    return cfg


def _parse_vector(s):
    return np.array([float(x) for x in str(s).split(",")])


def _parse_matrix(s):
    return np.array([[float(x) for x in row.split(",")]
                     for row in str(s).split(";")])
