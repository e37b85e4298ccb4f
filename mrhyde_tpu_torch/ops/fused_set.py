"""Fused assembly of module sets, and of coefficients that read the
state, on uniform structured meshes: the node-scatter kernel B2 on 2D p1
quads and the element-tile kernel B1 on 3D hex (p1) and 2D p2 quads, in
mode "full", each through one CUDA kernel generated per deck.

The port of the JAX package's `FusedP1Assembly` (mrhyde_tpu/ops/
fused_p1.py) for the decks its TPU kernels (B2 `run_node_call`, B1
`run_call`) carry that the port's specialized kernels do not:
- a module SET drawn from navier stokes, thermal and cdr (NS + thermal
  with the Boussinesq term, NS + cdr, thermal + cdr, ...): JAX's
  `_density` sums the modules' `qp_density` and its kernel
  differentiates the sum;
- a thermal or cdr velocity, or an NS density, viscosity or source,
  that reads the state (JAX's `QpCtx.resolve` hands the kernel the
  state at the qp, and `_accumulate` differentiates through it).
Every assembly is ONE launch: on 2D p1 quads of `set_node_full`, the
node-scattered residual of every variable and the element-varying
Jacobian rows; on hex and p2 quads (JAX's `use_node` picks B1 there) of
`set_elem_full`, the nd residual rows and the element-varying Jacobian
rows of every element, whose residual rows the provider scatters
(fused_elem.scatter_rows, and `dof2fine` on the p2 fine lattice). Steady
calls and transient stages alike, as JAX's one-kernel path does.

Each kernel is a template (`csrc/set_node.cuh`, `csrc/set_elem.cuh`)
completed per deck:
functions/codegen.py writes the deck's coefficient expressions (the
deck's named functions inlined) into C++ over the kernel's scalar type,
so the duals of csrc/dual.cuh differentiate them inside the kernel, and
sums the modules' densities (csrc/ns_density.cuh, csrc/scalar_density.cuh)
as JAX's `_density` does. The source is built by nvcc at first use,
named by the sha of its text (ops/_build.py `load_generated`). Time and
the deck's scalar parameters are kernel arguments: the stages and steps
of a deck share one library.

The plain version is JAX's `_accumulate` ported over the sparse dual
numbers of `sparse_dual.py` (fused_ns.accumulate_density), on the
modules' own `qp_density` at a `SetCtx`, the counterpart of JAX's QpCtx:
the coefficient expressions are evaluated on sparse duals, whose rules
are JAX's. Row classification is JAX's `_probe` (the plain version on
(2,)-shaped stand-ins, twice), so `stats` equal JAX's where JAX runs the
one-kernel path. (A set whose density is affine, thermal + cdr with
constant coefficients, takes JAX's split path; here it takes the same
kernel, with the same numbers and other `stats`: ROADMAP §C.)

The wrappers run the plain version on CPU tensors and the kernel on CUDA
tensors, and count their launches in LAUNCHES["set_node_full"] and
LAUNCHES["set_elem_full"].
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import BlockJacobian
from mrhyde_tpu_torch.functions import codegen
from mrhyde_tpu_torch.ops import fused_elem as fe
from mrhyde_tpu_torch.ops._launch import LAUNCHES, stream
from mrhyde_tpu_torch.ops.fused_ns import (
    StageCache, _check_classes, _check_grid_stacks, _dummy, _row_pos,
    _stack_rows, accumulate_density, classify_probes, rows_of)
from mrhyde_tpu_torch.ops.fused_p1 import (
    QUAD_P1, Stage, _check_grid, qp_coords, structured_geometry)

__all__ = ["FusedSetAssembly", "SetForm", "SetScalars", "SetCtx",
           "set_node_full", "set_node_full_plain", "set_elem_full",
           "set_elem_full_plain", "MAX_SCALARS"]

# the kernels' SetArgs limits (csrc/set_node.cuh, csrc/set_elem.cuh)
MAX_Q = 16
MAX_Q_ELEM = 27
MAX_SCALARS = 32
_KINDS = {"navierstokes", "thermal", "cdr"}


class SetCtx:
    """Per-qp context of a module set (the JAX package's fused QpCtx):
    the state, its time derivative and gradient per variable, the qp's
    coordinates, time, parameters and the stabilisation scalars. Values
    are tensors, Python floats or sparse duals."""

    def __init__(self, u, ud, g, coords, t, params, fm, h, deltat,
                 is_transient):
        self._u, self._ud, self._g = u, ud, g
        self.coords = coords
        self.t = t
        self.params = params
        self.fm = fm
        self.h = h
        self.deltat = deltat
        self.is_transient = is_transient

    def has(self, v):
        return v in self._u

    def sol(self, v):
        return self._u[v]

    def sol_dot(self, v):
        return self._ud[v]

    def grad(self, v):
        return self._g[v]

    def f(self, name):
        return self.fm.evaluate(name, self)

    def resolve(self, leaf):
        if leaf == "x":
            return self.coords[0]
        if leaf == "y":
            return self.coords[1]
        if leaf == "z" and len(self.coords) > 2:
            return self.coords[2]
        if leaf == "t":
            return self.t
        if leaf in self.params:
            return self.params[leaf]
        if leaf in self._u:
            return self._u[leaf]
        raise KeyError(f"fused assembly cannot resolve {leaf!r}")


class SetScalars(NamedTuple):
    """A call's scalars: time, the stage's time step and the deck's
    parameter values (in SetForm.params order)."""
    time: float
    deltat: float
    params: tuple


class SetForm:
    """The weak form of one module set as the kernel sees it: the
    modules in the deck's order, the FunctionManager, the variables in
    the kernel's order, the scalar parameters' names, the element size
    h, whether the deck is transient, the dimension and the local dofs
    per variable (2 and 4: set_node_full on 2D p1 quads; 3 and 8 on hex,
    2 and 9 on p2 quads: set_elem_full), and the generated kernel source
    (functions/codegen.py; raises codegen.Unsupported at construction
    where a coefficient has no C++ form)."""

    def __init__(self, modules, fm, variables, params, h, transient, dim=2,
                 nc=4):
        self.modules = tuple(modules)
        self.fm = fm
        self.variables = tuple(variables)
        self.params = tuple(params)
        self.h = float(h)
        self.transient = bool(transient)
        self.dim = int(dim)
        self.nc = int(nc)
        ns = [m for m in modules if m.name == "navierstokes"]
        self.ns = ns[0] if ns else None
        if 3 + len(self.params) > MAX_SCALARS:
            raise codegen.Unsupported(f"{len(self.params)} parameters")
        names = [n for m in modules
                 for k, v in m.kernel_coefficients().items() if k != "kind"
                 for n in (v if isinstance(v, tuple) else (v,))]
        self.reads_time = any("t" in fm.terminal_leaves(n) for n in names)
        self.source = codegen.density_source(self.modules, self.variables,
                                             self.params, fm, self.dim,
                                             self.nc)

    def tau_dt2(self, deltat):
        """(C3/dt)^2 of tau: C3 = 2 in a transient deck, else 0."""
        return ((2.0 if self.transient else 0.0) / deltat) ** 2

    def scalars(self, sc):
        """The kernel's sc array: t, beta, T_ambient, the parameters."""
        ns = self.ns
        return (float(sc.time), ns.beta if ns else 1.0,
                ns.t_ambient if ns else 0.0) + tuple(map(float, sc.params))


def _density(form, coords_at, sc):
    """density(q, u, ud, g) -> [S_v for v] + [F_v,d for v for d]: the sum
    of the modules' qp densities at quadrature point q (JAX's
    `_density`: structural zeros where no module writes)."""
    params = dict(zip(form.params, sc.params))
    names = form.variables
    dim = form.dim

    def density(q, u_, ud_, g_):
        ctx = SetCtx(dict(zip(names, u_)), dict(zip(names, ud_)),
                     dict(zip(names, g_)), coords_at(q), float(sc.time),
                     params, form.fm, form.h, float(sc.deltat),
                     form.transient)
        S = {v: None for v in names}
        F = {v: [None] * dim for v in names}
        for m in form.modules:
            for v, (sv, fv) in m.qp_density(ctx).items():
                S[v] = sv if S[v] is None else S[v] + sv
                if fv is not None:
                    for d in range(dim):
                        F[v][d] = fv[d] if F[v][d] is None \
                            else F[v][d] + fv[d]
        return [0.0 if S[v] is None else S[v] for v in names] + \
               [0.0 if F[v][d] is None else F[v][d]
                for v in names for d in range(dim)]
    return density


def set_node_full_plain(form, ue, ud, sc, tab, geo, jac_idx, stage=None):
    """(node residual (nv, N0+1, N1+1), Jacobian rows (len(jac_idx), E)):
    the plain version of `set_node_full`. ue, ud: the (nv, N0+1, N1+1)
    u_eval and u_dot grids of the form's variables (ud None when steady);
    sc: SetScalars; geo: (origin, h_axes, q_off) of the box; jac_idx:
    the rows to return (row k = row*nd + col); stage: None (steady) or a
    Stage (alpha_u, alpha_t; its mass is unused)."""
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    steady = stage is None
    views = [fe.corner_values(g, QUAD_P1) for g in ue]
    dviews = [[0.0] * 4 for _ in views] if steady else \
        [fe.corner_values(g, QUAD_P1) for g in ud]
    origin, h_axes, q_off = geo
    xy = qp_coords((N0, N1), origin, h_axes, q_off, tab.Q, ue.dtype,
                   ue.device)
    density = _density(form, lambda q: [c[..., q].reshape(-1) for c in xy],
                       sc)
    res, jac = accumulate_density(views, dviews, density, tab,
                                  1.0 if steady else stage.alpha_u,
                                  0.0 if steady else stage.alpha_t, steady)
    _check_classes(jac, jac_idx)
    nv = len(views)
    node = torch.stack([fe.scatter_rows(res[vi * 4:(vi + 1) * 4], QUAD_P1,
                                        (N0, N1), ue) for vi in range(nv)])
    return node, _stack_rows(jac, jac_idx, N0 * N1, views[0][0])


def set_elem_full_plain(form, ue, ud, sc, tab, lat, geo, jac_idx,
                        stage=None):
    """(residual rows (nd, E), Jacobian rows (len(jac_idx), E)): the
    plain version of `set_elem_full`. ue, ud: the (nv, *grid) u_eval and
    u_dot grids of the form's variables (ud None when steady), each a p1
    node grid (hex) or a p2 fine lattice that `lat` reads; sc:
    SetScalars; geo: (origin, h_axes, q_off) of the box; jac_idx: the
    rows to return (row k = row*nd + col); stage: None (steady) or a
    Stage (alpha_u, alpha_t; its mass is unused)."""
    steady = stage is None
    views = [fe.corner_values(g, lat) for g in ue]
    dviews = [[0.0] * len(lat.offsets) for _ in views] if steady else \
        [fe.corner_values(g, lat) for g in ud]
    origin, h_axes, q_off = geo
    xyz = qp_coords(fe.elem_dims(ue[0], lat), origin, h_axes, q_off, tab.Q,
                    ue.dtype, ue.device)
    density = _density(form, lambda q: [c[..., q].reshape(-1) for c in xyz],
                       sc)
    res, jac = accumulate_density(views, dviews, density, tab,
                                  1.0 if steady else stage.alpha_u,
                                  0.0 if steady else stage.alpha_t, steady)
    _check_classes(jac, jac_idx)
    like = views[0][0]
    E = like.numel()
    return (_stack_rows(res, range(len(res)), E, like),
            _stack_rows(jac, jac_idx, E, like))


# ----------------------------------------------------------------------
# the kernel wrappers
# ----------------------------------------------------------------------

class _SetArgs(ctypes.Structure):
    """The C side's SetArgs (csrc/set_node.cuh), field for field."""
    _fields_ = [("ue", ctypes.c_void_p), ("ud", ctypes.c_void_p),
                ("phi", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("wts", ctypes.c_void_p), ("row_pos", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("jac", ctypes.c_void_p),
                ("alpha_u", ctypes.c_double), ("alpha_t", ctypes.c_double),
                ("h", ctypes.c_double), ("tau_dt2", ctypes.c_double),
                ("origin", ctypes.c_double * 2),
                ("hax", ctypes.c_double * 2),
                ("qoff", (ctypes.c_double * 2) * MAX_Q),
                ("sc", ctypes.c_double * MAX_SCALARS),
                ("Q", ctypes.c_int), ("N0", ctypes.c_int),
                ("N1", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("pspg", ctypes.c_int), ("supg", ctypes.c_int),
                ("transient", ctypes.c_int)]


def set_node_full(form, ue, ud, sc, tab, geo, jac_idx, stage=None):
    """(node residual (nv, N0+1, N1+1), Jacobian rows (len(jac_idx), E))
    of the set's weak form: the generated CUDA kernel on CUDA tensors,
    the plain version on CPU tensors. Arguments as
    `set_node_full_plain`."""
    if ue.device.type == "cpu":
        return set_node_full_plain(form, ue, ud, sc, tab, geo, jac_idx,
                                   stage)
    nv = len(form.variables)
    if ue.dim() != 3 or ue.shape[0] != nv:
        raise ValueError(f"ue must be a ({nv}, N0+1, N1+1) grid stack")
    _check_grid(ue[0], tab)
    _check_grid_stacks(ue, ud, stage)
    if tab.Q > MAX_Q:
        raise ValueError(f"set_node_full takes at most {MAX_Q} qps")
    steady = stage is None
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    E = N0 * N1
    origin, h_axes, q_off = geo
    a = _SetArgs()
    a.ue = ue.data_ptr()
    a.ud = None if ud is None else ud.data_ptr()
    a.phi, a.grad, a.wts = (tab.t_phi.data_ptr(), tab.t_grad.data_ptr(),
                            tab.t_wts.data_ptr())
    a.row_pos = _row_pos(jac_idx, 4 * nv, ue.device).data_ptr()
    out = torch.empty_like(ue)
    jac = torch.empty((len(jac_idx), E), dtype=ue.dtype, device=ue.device)
    a.res, a.jac = out.data_ptr(), jac.data_ptr()
    a.alpha_u = 1.0 if steady else float(stage.alpha_u)
    a.alpha_t = 0.0 if steady else float(stage.alpha_t)
    a.h, a.tau_dt2 = form.h, form.tau_dt2(float(sc.deltat))
    for d in range(2):
        a.origin[d], a.hax[d] = float(origin[d]), float(h_axes[d])
        for q in range(tab.Q):
            a.qoff[q][d] = float(q_off[q][d])
    for i, v in enumerate(form.scalars(sc)):
        a.sc[i] = v
    a.Q, a.N0, a.N1, a.n_rows = tab.Q, N0, N1, len(jac_idx)
    ns = form.ns
    a.pspg = int(bool(ns and ns.use_pspg))
    a.supg = int(bool(ns and ns.use_supg))
    a.transient = int(not steady)
    from mrhyde_tpu_torch.ops._build import load_generated
    lib = load_generated(form.source)
    fn = (lib.set_node_full_f64 if ue.dtype == torch.float64
          else lib.set_node_full_f32)
    err = fn(ctypes.c_void_p(ctypes.addressof(a)), stream(ue))
    if err != 0:
        raise RuntimeError(f"set_node_full launch failed: CUDA error {err}")
    LAUNCHES["set_node_full"] += 1
    return out, jac


class _SetElemArgs(ctypes.Structure):
    """The C side's SetArgs of csrc/set_elem.cuh, field for field."""
    _fields_ = [("ue", ctypes.c_void_p), ("ud", ctypes.c_void_p),
                ("phi", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("wts", ctypes.c_void_p), ("row_pos", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("jac", ctypes.c_void_p),
                ("alpha_u", ctypes.c_double), ("alpha_t", ctypes.c_double),
                ("h", ctypes.c_double), ("tau_dt2", ctypes.c_double),
                ("origin", ctypes.c_double * 3),
                ("hax", ctypes.c_double * 3),
                ("qoff", (ctypes.c_double * 3) * MAX_Q_ELEM),
                ("sc", ctypes.c_double * MAX_SCALARS),
                ("Q", ctypes.c_int), ("stride", ctypes.c_int),
                ("N0", ctypes.c_int), ("N1", ctypes.c_int),
                ("N2", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("pspg", ctypes.c_int), ("supg", ctypes.c_int),
                ("transient", ctypes.c_int),
                ("off", (ctypes.c_int * 3) * 9)]


def _elem_args(form, ue, ud, sc, tab, lat, geo, jac_idx, stage):
    """(_SetElemArgs, residual rows, Jacobian rows) of one set_elem_full
    call: the C struct filled from the arguments, and the outputs it
    points to, allocated on ue's device."""
    nv, nc, dim = len(form.variables), len(lat.offsets), tab.dim
    if ue.dim() != dim + 1 or ue.shape[0] != nv:
        raise ValueError(f"ue must be a ({nv}, *grid) stack of the "
                         f"variables' grids")
    if (dim, nc) != (form.dim, form.nc):
        raise ValueError(f"the form is generated for dim {form.dim}, nc "
                         f"{form.nc}, not dim {dim}, nc {nc}")
    _check_grid_stacks(ue, ud, stage)
    if tab.Q > MAX_Q_ELEM:
        raise ValueError(f"set_elem_full takes at most {MAX_Q_ELEM} qps")
    steady = stage is None
    nd = nv * nc
    dims = list(fe.elem_dims(ue[0], lat)) + [1] * (3 - dim)
    E = math.prod(dims)
    origin, h_axes, q_off = geo
    a = _SetElemArgs()
    a.ue = ue.data_ptr()
    a.ud = None if ud is None else ud.data_ptr()
    a.phi, a.grad, a.wts = (tab.t_phi.data_ptr(), tab.t_grad.data_ptr(),
                            tab.t_wts.data_ptr())
    a.row_pos = _row_pos(jac_idx, nd, ue.device).data_ptr()
    res = torch.empty((nd, E), dtype=ue.dtype, device=ue.device)
    jac = torch.empty((len(jac_idx), E), dtype=ue.dtype, device=ue.device)
    a.res, a.jac = res.data_ptr(), jac.data_ptr()
    a.alpha_u = 1.0 if steady else float(stage.alpha_u)
    a.alpha_t = 0.0 if steady else float(stage.alpha_t)
    a.h, a.tau_dt2 = form.h, form.tau_dt2(float(sc.deltat))
    for d in range(dim):
        a.origin[d], a.hax[d] = float(origin[d]), float(h_axes[d])
        for q in range(tab.Q):
            a.qoff[q][d] = float(q_off[q][d])
    for i, v in enumerate(form.scalars(sc)):
        a.sc[i] = v
    a.Q, a.stride, a.n_rows = tab.Q, lat.stride, len(jac_idx)
    a.N0, a.N1, a.N2 = dims
    for c, off in enumerate(lat.offsets):
        for ax, o in enumerate(off):
            a.off[c][ax] = int(o)
    ns = form.ns
    a.pspg = int(bool(ns and ns.use_pspg))
    a.supg = int(bool(ns and ns.use_supg))
    a.transient = int(not steady)
    return a, res, jac


def set_elem_full(form, ue, ud, sc, tab, lat, geo, jac_idx, stage=None):
    """(residual rows (nd, E), Jacobian rows (len(jac_idx), E)) of the
    set's weak form on hex p1 or p2 quads: the generated CUDA kernel on
    CUDA tensors, the plain version on CPU tensors. Arguments as
    `set_elem_full_plain`."""
    if ue.device.type == "cpu":
        return set_elem_full_plain(form, ue, ud, sc, tab, lat, geo,
                                   jac_idx, stage)
    fe._check_grid(ue[0], tab, lat)
    a, res, jac = _elem_args(form, ue, ud, sc, tab, lat, geo, jac_idx,
                             stage)
    from mrhyde_tpu_torch.ops._build import load_generated
    lib = load_generated(form.source)
    fn = (lib.set_elem_full_f64 if ue.dtype == torch.float64
          else lib.set_elem_full_f32)
    err = fn(ctypes.c_void_p(ctypes.addressof(a)), stream(ue))
    if err != 0:
        raise RuntimeError(f"set_elem_full launch failed: CUDA error {err}")
    LAUNCHES["set_elem_full"] += 1
    return res, jac


# ----------------------------------------------------------------------
# the provider
# ----------------------------------------------------------------------

class FusedSetAssembly:
    """Fused residual+Jacobian provider for module sets, and for
    coefficients that read the state, on uniform structured meshes: every
    call one launch, steady calls and transient stages alike, of
    `set_node_full` on 2D p1 quads (B2) or of `set_elem_full` on 3D hex
    p1 and 2D p2 quads (B1), as the JAX package's `use_node` picks.
    `FusedSetAssembly.build(asm)` -> instance, or None where the mesh
    does not qualify or a coefficient has no generated form (the general
    path)."""

    def __init__(self, asm, form):
        self.asm = asm
        self.form = form
        (self.dims, self.origin, self.h_axes, self.q_off,
         self.tables) = structured_geometry(asm)
        s = asm._structured
        kind = s["plan"][0][0]
        self.starts = [st for (_k, _n, st) in s["plan"]]
        self.nv = len(self.starts)
        self.node = len(self.dims) == 2 and kind == "p1"
        (self.lattice, self.grid_shape, self.fine_idx,
         self.dof2fine) = fe.structured_lattice(asm, self.dims, self.starts)
        # p1: consecutive node-grid blocks are one view, else one gather
        self.grid_idx = None
        ng = math.prod(self.grid_shape)
        if kind == "p1" and self.starts != [self.starts[0] + i * ng
                                            for i in range(self.nv)]:
            self.grid_idx = torch.as_tensor(
                np.asarray(self.starts)[:, None] + np.arange(ng)[None, :],
                device=asm.device)
        self.nc = len(self.lattice.offsets)
        self.nd = self.nc * self.nv
        self._probes = {}
        self._stage = StageCache()
        self.stats = {"steady": True, "split": False, "n_res_rows": self.nd,
                      "n_jac_rows": 0, "node_scatter": self.node}

    @staticmethod
    def build(asm):
        """The provider of a qualifying deck (2D p1 quads, 3D p1 hex or
        2D p2 quads) whose modules are all navier stokes, thermal or cdr,
        or None (the general path) where the mesh does not qualify or a
        coefficient has no generated form."""
        s = asm._structured
        if s is None or not asm.uniform \
                or any(m.name not in _KINDS for m in asm.modules):
            return None
        cell = asm.disc.mesh.cell_type
        kinds = {k for (k, _n, _st) in s["plan"]}
        dim = len(s["dims"])
        if kinds == {"p1"} and (dim, cell) in ((2, "quad"), (3, "hex")):
            nc = 4 if dim == 2 else 8
        elif kinds == {"p2"} and (dim, cell) == (2, "quad"):
            nc = 9
        else:
            return None
        wts = np.asarray(asm.disc.wts[0])
        if wts.size > (MAX_Q if nc == 4 else MAX_Q_ELEM):
            return None
        scalars = sorted(k for k, v in asm.params.items()
                         if np.ndim(v) == 0)
        try:
            form = SetForm(asm.modules, asm.fm,
                           [n for (_k, n, _st) in s["plan"]], scalars,
                           float(np.sum(wts) ** (1.0 / dim)),
                           asm.is_transient, dim, nc)
        except codegen.Unsupported:
            return None
        return FusedSetAssembly(asm, form)

    # ------------------------------------------------------------------

    def _grids(self, v):
        """The (nv, *grid) grids of the variables in a dof vector: node
        grids (p1: one view of consecutive blocks, else one gather) or
        fine lattices (p2: one gather)."""
        if self.fine_idx is not None:
            return v[self.fine_idx]
        if self.grid_idx is not None:
            return v[self.grid_idx].reshape(self.nv, *self.grid_shape)
        n = math.prod(self.grid_shape)
        return v[self.starts[0]:self.starts[0] + self.nv * n].reshape(
            self.nv, *self.grid_shape)

    def _scalars(self, tc, pvec):
        params = dict(self.asm.params)
        params.update({k: float(v) for k, v in (pvec or {}).items()})
        return SetScalars(float(tc.time), float(tc.deltat),
                          tuple(float(params[k]) for k in self.form.params))

    def _probe(self, sc, alpha_u, alpha_t, steady, salt):
        """JAX's _probe: the plain version's accumulation on (2,)-shaped
        stand-ins for the local dofs' values and the coordinates, on the
        CPU."""
        dt = self.asm.dtype
        ue, ud = [], []
        k = 0
        for _v in range(self.nv):
            ue.append([])
            ud.append([])
            for _c in range(self.nc):
                uc = _dummy(k, salt, dt)
                if steady:
                    ue[-1].append(uc)
                    ud[-1].append(0.0)
                else:
                    ue[-1].append(alpha_u * uc + _dummy(k + 1, salt, dt))
                    ud[-1].append(alpha_t * uc + _dummy(k + 2, salt, dt))
                k += 3
        coords = [_dummy(k + a, salt, dt) for a in range(len(self.dims))]
        density = _density(self.form, lambda _q: coords, sc)
        return accumulate_density(ue, ud, density, self.tables, alpha_u,
                                  alpha_t, steady)

    def _classify(self, sc, alpha_u, alpha_t, steady):
        """(jac_idx, jac constants, n_res) of a call, cached per its
        scalars (the time among them where a coefficient reads it)."""
        if not self.form.reads_time:
            sc = sc._replace(time=0.0)
        key = (steady, alpha_u, alpha_t, sc)
        if key not in self._probes:
            self._probes[key] = classify_probes(
                lambda salt: self._probe(sc, alpha_u, alpha_t, steady,
                                         salt))
        return self._probes[key]

    def res_jac(self, u, tc, pvec=None):
        """(residual (n_dof,), Jacobian rows: list of nd*nd entries, each
        None, a 0-d tensor or an (E,) tensor)."""
        asm = self.asm
        steady = self._stage.is_steady(tc)
        alpha_u = 1.0 if steady else float(tc.alpha_u)
        alpha_t = 0.0 if steady else float(tc.alpha_t)
        sc = self._scalars(tc, pvec)
        jac_idx, consts, n_res = self._classify(sc, alpha_u, alpha_t,
                                                steady)
        self.stats = {"steady": steady, "split": False, "n_res_rows": n_res,
                      "n_jac_rows": len(jac_idx), "node_scatter": self.node}
        if steady:
            ue, ud, stage = self._grids(u), None, None
        else:
            ue = self._grids(alpha_u * u + tc.beta_u)
            ud = self._grids(alpha_t * u + tc.beta_t).contiguous()
            stage = Stage(alpha_u, alpha_t, None)
        ue = ue.contiguous()
        geo = (self.origin, self.h_axes, self.q_off)
        r = torch.zeros(asm.n_dof, dtype=u.dtype, device=u.device)
        if self.node:
            node, jac = set_node_full(self.form, ue, ud, sc, self.tables,
                                      geo, jac_idx, stage)
            for vi, st in enumerate(self.starts):
                r[st:st + node[vi].numel()] = node[vi].reshape(-1)
        else:
            res, jac = set_elem_full(self.form, ue, ud, sc, self.tables,
                                     self.lattice, geo, jac_idx, stage)
            fe.scatter_dofs(res, r, self.starts, self.lattice, self.dims,
                            ue[0], self.dof2fine)
        rows = rows_of(jac_idx, consts, jac, self.nd, asm.dtype, asm.device)
        return torch.where(asm.fixed, 0.0, r), rows

    def jacobian(self, u, tc, pvec=None):
        """(residual, BlockJacobian) with the kernel's SoA row layout."""
        r, rows = self.res_jac(u, tc, pvec)
        return r, BlockJacobian(vol=None, vol_lids=self.asm.lids,
                                fixed=self.asm.fixed, inc=self.asm.inc,
                                vol_soa=rows)
