"""Fused assembly of module sets, and of coefficients that read the
state, on uniform structured meshes: the node-scatter kernel B2 on 2D p1
quads and the element-tile kernel B1 on 3D hex (p1) and 2D p2 quads,
each through CUDA kernels generated per deck, in mode "full" and, for an
affine set, in mode "state".

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
Mode "full" is ONE launch per assembly: on 2D p1 quads of
`set_node_full`, the node-scattered residual of every variable and the
element-varying Jacobian rows; on hex and p2 quads (JAX's `use_node`
picks B1 there) of `set_elem_full`, the nd residual rows and the
element-varying Jacobian rows of every element, whose residual rows the
provider scatters (fused_elem.scatter_rows, and `dof2fine` on the p2
fine lattice). Steady calls and transient stages alike.

A set whose summed density is AFFINE in the state (thermal + cdr whose
coefficients read no state) takes JAX's split path, as JAX's
`_detect_affine` decides it (a randomized probe of the plain version):
per assembly one launch of `set_node_state` (B2) or `set_elem_state`
(B1), JAX's mode "state", which reads the u grid alone and writes the
residual of the densities' derivative along the state, plus the
state-independent coord part (JAX's `_coord_eval`): the density at the
betas and the whole Jacobian, in plain torch, cached per stage and
scalars, since a Newton solve does not move it. `stats` are JAX's:
"split": True, the state part's and the coord part's row counts.

Each kernel is a template (`csrc/set_node.cuh`, `csrc/set_elem.cuh`)
completed per deck:
functions/codegen.py writes the deck's coefficient expressions (the
deck's named functions inlined) into C++ over the kernel's scalar type,
so the duals of csrc/dual.cuh differentiate them inside the kernel, and
sums the modules' densities (csrc/ns_density.cuh, csrc/scalar_density.cuh)
as JAX's `_density` does. The source is built by nvcc at first use,
named by the sha of its text (ops/_build.py `load_generated`); every
library holds both modes. Time and the deck's scalar parameters are
kernel arguments: the stages and steps of a deck share one library.
The kernels take any quadrature: a block holds fewer than 16 elements
where 16 would not fit the card's shared memory, and `build` refuses,
with a clear error, a quadrature whose one element would not fit
either (ops/_launch.py, the layouts' formulas).

The plain version is JAX's `_accumulate` ported over the sparse dual
numbers of `sparse_dual.py` (fused_ns.accumulate_density, modes "full"
and "lin"), on the modules' own `qp_density` at a `SetCtx`, the
counterpart of JAX's QpCtx: the coefficient expressions are evaluated on
sparse duals, whose rules are JAX's. Row classification is JAX's
`_probe` (the plain version on (2,)-shaped stand-ins, twice), so `stats`
equal JAX's.

The wrappers run the plain version on CPU tensors and the kernel on CUDA
tensors, and count their launches in LAUNCHES["set_node_full"],
["set_elem_full"], ["set_node_state"] and ["set_elem_state"].
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
from mrhyde_tpu_torch.ops._launch import (
    ELEM_MAX_SCALARS, LAUNCHES, ElemArgs, check_err, check_smem,
    elem_smem_words, elem_state_smem_words, elem_tiles, node_smem_words,
    set_state_smem_words, stream)
from mrhyde_tpu_torch.ops.fused_ns import (
    StageCache, _check_classes, _check_grid_stacks, _dummy, _row_pos,
    _stack_rows, accumulate_density, classify_probes, rows_of)
from mrhyde_tpu_torch.ops.fused_p1 import (
    QUAD_P1, Stage, _check_grid, qp_coords, structured_geometry)

__all__ = ["FusedSetAssembly", "SetForm", "SetScalars", "SetCtx",
           "set_node_full", "set_node_full_plain", "set_elem_full",
           "set_elem_full_plain", "set_node_state", "set_node_state_plain",
           "set_elem_state", "set_elem_state_plain", "MAX_SCALARS"]

# the kernels' scalar limit (csrc/set_node.cuh SetArgs, csrc/
# elem_engine.cuh ElemArgs)
MAX_SCALARS = ELEM_MAX_SCALARS
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
        # the bound entry points of the source's library, by (name, dtype)
        self.entries = {}

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
                ("qoff", ctypes.c_void_p),
                ("sc", ctypes.c_double * MAX_SCALARS),
                ("Q", ctypes.c_int), ("N0", ctypes.c_int),
                ("N1", ctypes.c_int), ("n_rows", ctypes.c_int),
                ("pspg", ctypes.c_int), ("supg", ctypes.c_int),
                ("transient", ctypes.c_int), ("tiles", ctypes.c_void_p),
                ("n_tiles", ctypes.c_int)]


_QOFF = {}


def _qoff(q_off, dim, device):
    """The qps' offsets in an element as the kernels read them: a (Q,
    dim) float64 tensor on the device, one copy per distinct table."""
    a = np.ascontiguousarray(np.asarray(q_off, dtype=np.float64)[:, :dim])
    key = (str(device), a.tobytes())
    if key not in _QOFF:
        _QOFF[key] = torch.as_tensor(a, device=device)
    return _QOFF[key]


def _node_args(form, ue, ud, sc, tab, geo, jac_idx, stage, lin):
    """(_SetArgs, node residual, Jacobian rows, keep-alive) of one
    set_node_* call: the C struct filled from the arguments, and the
    outputs it points to, allocated on ue's device (`lin`: mode "state",
    ue the u grid, no Jacobian)."""
    nv = len(form.variables)
    if ue.dim() != 3 or ue.shape[0] != nv:
        raise ValueError(f"ue must be a ({nv}, N0+1, N1+1) grid stack")
    if lin:
        if ud is not None:
            raise ValueError("set_node_state reads the u grid alone")
        if not ue.is_contiguous():
            raise ValueError("the u grids must be contiguous")
    else:
        _check_grid_stacks(ue, ud, stage)
    steady = stage is None
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    E = N0 * N1
    origin, h_axes, q_off = geo
    a = _SetArgs()
    a.ue = ue.data_ptr()
    a.ud = None if ud is None else ud.data_ptr()
    a.phi, a.grad, a.wts = (tab.t_phi.data_ptr(), tab.t_grad.data_ptr(),
                            tab.t_wts.data_ptr())
    out = torch.empty_like(ue)
    a.res = out.data_ptr()
    pos = tiles = jac = None
    if not lin:
        # mode "state" reads no Jacobian fields: they stay null
        pos = _row_pos(jac_idx, 4 * nv, ue.device)
        a.row_pos = pos.data_ptr()
        tiles = elem_tiles(jac_idx, nv, 4, ue.device)
        a.tiles, a.n_tiles = tiles.data_ptr(), tiles.numel()
        jac = torch.empty((len(jac_idx), E), dtype=ue.dtype,
                          device=ue.device)
        a.jac = jac.data_ptr()
    a.alpha_u = 1.0 if steady else float(stage.alpha_u)
    a.alpha_t = 0.0 if steady else float(stage.alpha_t)
    a.h, a.tau_dt2 = form.h, form.tau_dt2(float(sc.deltat))
    for d in range(2):
        a.origin[d], a.hax[d] = float(origin[d]), float(h_axes[d])
    qoff = _qoff(q_off, 2, ue.device)
    a.qoff = qoff.data_ptr()
    for i, v in enumerate(form.scalars(sc)):
        a.sc[i] = v
    a.Q, a.N0, a.N1, a.n_rows = tab.Q, N0, N1, len(jac_idx)
    ns = form.ns
    a.pspg = int(bool(ns and ns.use_pspg))
    a.supg = int(bool(ns and ns.use_supg))
    a.transient = int(not steady)
    return a, out, jac, (pos, tiles, qoff)


def _launch(name, form, a, like):
    """One launch of a generated entry point on like's dtype and stream,
    counted; the entry point is bound once per (form, name, dtype)."""
    key = (name, like.dtype)
    fn = form.entries.get(key)
    if fn is None:
        from mrhyde_tpu_torch.ops._build import load_generated
        lib = load_generated(form.source)
        fn = form.entries[key] = getattr(
            lib, f"{name}_f64" if like.dtype == torch.float64
            else f"{name}_f32")
    check_err(name, fn(ctypes.addressof(a), stream(like)), a.Q)
    LAUNCHES[name] += 1


def set_node_full(form, ue, ud, sc, tab, geo, jac_idx, stage=None):
    """(node residual (nv, N0+1, N1+1), Jacobian rows (len(jac_idx), E))
    of the set's weak form: the generated CUDA kernel on CUDA tensors,
    the plain version on CPU tensors. Arguments as
    `set_node_full_plain`."""
    if ue.device.type == "cpu":
        return set_node_full_plain(form, ue, ud, sc, tab, geo, jac_idx,
                                   stage)
    _check_grid(ue[0], tab)
    a, out, jac, _keep = _node_args(form, ue, ud, sc, tab, geo, jac_idx,
                                    stage, False)
    _launch("set_node_full", form, a, ue)
    return out, jac


def set_node_state_plain(form, u, sc, tab, geo, stage=None):
    """(nv, N0+1, N1+1) node residual of an affine set's state part: the
    plain version of `set_node_state` (JAX's `_accumulate` mode "lin" on
    the pure state, u_eval = alpha_u u, u_dot = alpha_t u; steady: u).
    u: the (nv, N0+1, N1+1) grids of the form's variables; sc:
    SetScalars; geo: (origin, h_axes, q_off); stage: None or a Stage."""
    N0, N1 = u.shape[1] - 1, u.shape[2] - 1
    res = _state_rows(form, u, sc, tab, QUAD_P1, geo, stage)
    return torch.stack([fe.scatter_rows(res[vi * 4:(vi + 1) * 4], QUAD_P1,
                                        (N0, N1), u)
                        for vi in range(len(form.variables))])


def _state_rows(form, u, sc, tab, lat, geo, stage):
    """The nd residual rows of an affine set's state part (JAX's mode
    "lin"), each an element tensor or None."""
    steady = stage is None
    au = 1.0 if steady else float(stage.alpha_u)
    at = 0.0 if steady else float(stage.alpha_t)
    views = [fe.corner_values(g, lat) for g in u]
    ue = [[c if steady else au * c for c in v] for v in views]
    ud = [[0.0 if steady else at * c for c in v] for v in views]
    origin, h_axes, q_off = geo
    xyz = qp_coords(fe.elem_dims(u[0], lat), origin, h_axes, q_off, tab.Q,
                    u.dtype, u.device)
    density = _density(form, lambda q: [c[..., q].reshape(-1) for c in xyz],
                       sc)
    res, _ = accumulate_density(ue, ud, density, tab, au, at, steady,
                                mode="lin")
    return [0.0 if r is None else r for r in res]


def set_node_state(form, u, sc, tab, geo, stage=None):
    """(nv, N0+1, N1+1) node residual of an affine set's state part on 2D
    p1 quads: the generated CUDA kernel (mode "state" of B2) on CUDA
    tensors, the plain version on CPU tensors. Arguments as
    `set_node_state_plain`."""
    if u.device.type == "cpu":
        return set_node_state_plain(form, u, sc, tab, geo, stage)
    _check_grid(u[0], tab)
    a, out, _jac, _keep = _node_args(form, u, None, sc, tab, geo, (), stage,
                                     True)
    _launch("set_node_state", form, a, u)
    return out


_OFFSETS = {}


def _offsets(lat):
    """The lattice's local dof offsets as ElemArgs.off holds them, built
    once per lattice."""
    arr = _OFFSETS.get(lat)
    if arr is None:
        arr = _OFFSETS[lat] = type(ElemArgs().off)()
        for c, off in enumerate(lat.offsets):
            for ax, o in enumerate(off):
                arr[c][ax] = int(o)
    return arr


def _elem_args(form, ue, ud, sc, tab, lat, geo, jac_idx, stage,
               lin=False):
    """(ElemArgs, residual rows, Jacobian rows, keep-alive) of one
    set_elem_* call: the C struct filled from the arguments, and the
    outputs it points to, allocated on ue's device (`lin`: mode "state",
    ue the u grid, no Jacobian)."""
    nv, nc, dim = len(form.variables), len(lat.offsets), tab.dim
    if ue.dim() != dim + 1 or ue.shape[0] != nv:
        raise ValueError(f"ue must be a ({nv}, *grid) stack of the "
                         f"variables' grids")
    if (dim, nc) != (form.dim, form.nc):
        raise ValueError(f"the form is generated for dim {form.dim}, nc "
                         f"{form.nc}, not dim {dim}, nc {nc}")
    if lin:
        if ud is not None:
            raise ValueError("set_elem_state reads the u grid alone")
        if not ue.is_contiguous():
            raise ValueError("the u grids must be contiguous")
    else:
        _check_grid_stacks(ue, ud, stage)
    steady = stage is None
    nd = nv * nc
    dims = list(fe.elem_dims(ue[0], lat)) + [1] * (3 - dim)
    E = math.prod(dims)
    origin, h_axes, q_off = geo
    a = ElemArgs()
    a.ue = ue.data_ptr()
    a.ud = None if ud is None else ud.data_ptr()
    a.phi, a.grad, a.wts = (tab.t_phi.data_ptr(), tab.t_grad.data_ptr(),
                            tab.t_wts.data_ptr())
    res = torch.empty((nd, E), dtype=ue.dtype, device=ue.device)
    a.res = res.data_ptr()
    pos = tiles = jac = None
    if not lin:
        # mode "state" reads no Jacobian fields: they stay null
        pos = _row_pos(jac_idx, nd, ue.device)
        a.row_pos = pos.data_ptr()
        tiles = elem_tiles(jac_idx, nv, nc, ue.device)
        a.tiles, a.n_tiles = tiles.data_ptr(), tiles.numel()
        jac = torch.empty((len(jac_idx), E), dtype=ue.dtype,
                          device=ue.device)
        a.jac = jac.data_ptr()
    a.alpha_u = 1.0 if steady else float(stage.alpha_u)
    a.alpha_t = 0.0 if steady else float(stage.alpha_t)
    a.h, a.tau_dt2 = form.h, form.tau_dt2(float(sc.deltat))
    for d in range(dim):
        a.origin[d], a.hax[d] = float(origin[d]), float(h_axes[d])
    qoff = _qoff(q_off, dim, ue.device)
    a.qoff = qoff.data_ptr()
    for i, v in enumerate(form.scalars(sc)):
        a.sc[i] = v
    a.Q, a.nc, a.dim, a.stride = tab.Q, nc, dim, lat.stride
    a.N0, a.N1, a.N2 = dims
    a.off = _offsets(lat)
    ns = form.ns
    a.pspg = int(bool(ns and ns.use_pspg))
    a.supg = int(bool(ns and ns.use_supg))
    a.transient = int(not steady)
    return a, res, jac, (pos, tiles, qoff)


def set_elem_full(form, ue, ud, sc, tab, lat, geo, jac_idx, stage=None):
    """(residual rows (nd, E), Jacobian rows (len(jac_idx), E)) of the
    set's weak form on hex p1 or p2 quads: the generated CUDA kernel on
    CUDA tensors, the plain version on CPU tensors. Arguments as
    `set_elem_full_plain`."""
    if ue.device.type == "cpu":
        return set_elem_full_plain(form, ue, ud, sc, tab, lat, geo,
                                   jac_idx, stage)
    fe._check_grid(ue[0], tab, lat)
    a, res, jac, _keep = _elem_args(form, ue, ud, sc, tab, lat, geo,
                                    jac_idx, stage)
    _launch("set_elem_full", form, a, ue)
    return res, jac


def set_elem_state_plain(form, u, sc, tab, lat, geo, stage=None):
    """(nd, E) residual rows of an affine set's state part on hex p1 or
    p2 quads: the plain version of `set_elem_state` (JAX's `_accumulate`
    mode "lin" on the pure state). u: the (nv, *grid) grids of the form's
    variables (p1 node grids or p2 fine lattices that `lat` reads);
    other arguments as `set_node_state_plain`."""
    res = _state_rows(form, u, sc, tab, lat, geo, stage)
    like = fe.corner_values(u[0], lat)[0]
    return _stack_rows(res, range(len(res)), like.numel(), like)


def set_elem_state(form, u, sc, tab, lat, geo, stage=None):
    """(nd, E) residual rows of an affine set's state part on hex p1 or
    p2 quads: the generated CUDA kernel (mode "state" of B1) on CUDA
    tensors, the plain version on CPU tensors. Arguments as
    `set_elem_state_plain`."""
    if u.device.type == "cpu":
        return set_elem_state_plain(form, u, sc, tab, lat, geo, stage)
    fe._check_grid(u[0], tab, lat)
    a, res, _jac, _keep = _elem_args(form, u, None, sc, tab, lat, geo, (),
                                     stage, lin=True)
    _launch("set_elem_state", form, a, u)
    return res


# ----------------------------------------------------------------------
# the provider
# ----------------------------------------------------------------------

class FusedSetAssembly:
    """Fused residual+Jacobian provider for module sets, and for
    coefficients that read the state, on uniform structured meshes:
    `set_node_*` on 2D p1 quads (B2) and `set_elem_*` on 3D hex p1 and 2D
    p2 quads (B1), as the JAX package's `use_node` picks, steady calls
    and transient stages alike. A set whose density is affine in the
    state (JAX's `_detect_affine`, with the coord part's Jacobian classes
    those of the one-kernel path) takes JAX's split path: per call one
    launch of the state kernel (`set_node_state`, `set_elem_state`) plus
    the coord part, plain torch computed once per stage and scalars;
    every other call is one launch of the "full" kernel.
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
        self._affine = {}
        self._state_checked = False
        self._stage = StageCache()
        self._stage_cache = None
        self._coords = None
        self.stats = {"steady": True, "split": False, "n_res_rows": self.nd,
                      "n_jac_rows": 0, "node_scatter": self.node}

    @staticmethod
    def build(asm):
        """The provider of a qualifying deck (2D p1 quads, 3D p1 hex or
        2D p2 quads) whose modules are all navier stokes, thermal or cdr,
        or None (the general path) where the mesh does not qualify or a
        coefficient has no generated form. A quadrature whose one
        element's qp state exceeds the card's shared memory per block
        raises ValueError (here for mode "full"; for mode "state" at an
        affine set's first state launch, `_check_state_layout`)."""
        s = asm._structured
        if s is None or not asm.uniform or asm.general_only \
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
        nv, Q, tr = len(s["plan"]), wts.size, asm.is_transient
        # mode "full"'s layout for every set
        if nc == 4:
            check_smem("set_node_full", lambda el: node_smem_words(
                nv, tr, Q, el), asm.dtype.itemsize, Q)
        else:
            check_smem("set_elem_full", lambda el: elem_smem_words(
                dim, nc, nv, tr, Q, el), asm.dtype.itemsize, Q)
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

    def _check_state_layout(self):
        """Mode "state"'s layout, checked at the first state launch: only
        an affine set launches the state kernel (ValueError past the
        card's shared memory, as `build` for mode "full")."""
        if self._state_checked:
            return
        Q, itemsize = self.tables.Q, self.asm.dtype.itemsize
        if self.node:
            check_smem("set_node_state",
                       lambda el: set_state_smem_words(self.nv, Q),
                       itemsize, Q)
        else:
            check_smem("set_elem_state", lambda el: elem_state_smem_words(
                len(self.dims), self.nc, Q), itemsize, Q)
        self._state_checked = True

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

    def _probe(self, sc, alpha_u, alpha_t, steady, salt, state_salt=None,
               mode="full", dtype=None):
        """JAX's _probe: the plain version's accumulation on (2,)-shaped
        stand-ins for the local dofs' values and the coordinates, on the
        CPU. mode "full" at the combined state; "zero" at the zero state
        (the betas' stand-ins kept: the coord part); "lin" the state part
        (the stand-ins of the pure state alpha_u u, alpha_t u).
        `state_salt` shifts the state's stand-ins alone."""
        dt = self.asm.dtype if dtype is None else dtype
        ssalt = salt if state_salt is None else state_salt
        ue, ud = [], []
        k = 0
        for _v in range(self.nv):
            ue.append([])
            ud.append([])
            for _c in range(self.nc):
                uc = _dummy(k, ssalt, dt)
                if mode == "zero":
                    ue[-1].append(0.0 if steady else _dummy(k + 1, salt, dt))
                    ud[-1].append(0.0 if steady else _dummy(k + 2, salt, dt))
                elif mode == "lin":
                    ue[-1].append(uc if steady else alpha_u * uc)
                    ud[-1].append(0.0 if steady else alpha_t * uc)
                elif steady:
                    ue[-1].append(uc)
                    ud[-1].append(0.0)
                else:
                    ue[-1].append(alpha_u * uc + _dummy(k + 1, salt, dt))
                    ud[-1].append(alpha_t * uc + _dummy(k + 2, salt, dt))
                k += 3
        coords = [_dummy(k + a, salt, dt) for a in range(len(self.dims))]
        density = _density(self.form, lambda _q: coords, sc)
        res, jac = accumulate_density(
            ue, ud, density, self.tables, alpha_u, alpha_t, steady,
            mode="lin" if mode == "lin" else "full")
        return res, (jac or [])

    def _classify(self, sc, alpha_u, alpha_t, steady, mode="full"):
        """(jac_idx, jac constants, n_res) of a call's mode, cached per
        its scalars (the time among them where a coefficient reads it)."""
        if not self.form.reads_time:
            sc = sc._replace(time=0.0)
        key = (steady, alpha_u, alpha_t, sc, mode)
        if key not in self._probes:
            self._probes[key] = classify_probes(
                lambda salt: self._probe(sc, alpha_u, alpha_t, steady, salt,
                                         mode=mode))
        return self._probes[key]

    def _detect_affine(self, steady):
        """JAX's `_detect_affine`: True iff the summed density is affine
        in (u, u_dot, grad u), by randomized probing in f64 with concrete
        stand-ins for the call's scalars: the Jacobian must not move with
        the state's stand-ins, and the full residual must equal the
        zero-state part plus the state part. Any failure of the probes
        says no (the one-kernel path is always right)."""
        if steady in self._affine:
            return self._affine[steady]
        rng = np.random.RandomState(1234)
        a_u = 1.0 if steady else float(rng.uniform(0.6, 1.4))
        a_t = 0.0 if steady else float(rng.uniform(0.6, 1.4))
        t = float(rng.uniform(0.1, 0.9))
        dt_ = float(rng.uniform(0.1, 0.9))
        params = dict(self.asm.params)
        sc = SetScalars(t, dt_, tuple(float(params[k])
                                      for k in self.form.params))
        rtol, atol = 1e-9, 1e-12

        def conc(v):
            return np.asarray(0.0 if v is None else v, dtype=float)

        def probe(state_salt, mode="full"):
            return self._probe(sc, a_u, a_t, steady, 0.123, state_salt, mode,
                               torch.float64)
        ok = True
        try:
            r1, j1 = probe(0.519)
            _r2, j2 = probe(-0.41)
            ok = all((e1 is None) == (e2 is None) and (
                e1 is None or np.allclose(conc(e1), conc(e2), rtol=rtol,
                                          atol=atol))
                for e1, e2 in zip(j1, j2))
            if ok:
                rz, _ = probe(0.519, "zero")
                rl, _ = probe(0.519, "lin")
                ok = all(np.allclose(conc(r1[k]), conc(rz[k]) + conc(rl[k]),
                                     rtol=rtol, atol=atol)
                         for k in range(self.nd))
        except Exception:  # noqa: BLE001 - unsupported: no split
            ok = False
        self._affine[steady] = ok
        return ok

    def _qp_coords(self):
        if self._coords is None:
            self._coords = qp_coords(self.dims, self.origin, self.h_axes,
                                     self.q_off, self.tables.Q,
                                     self.asm.dtype, self.asm.device)
        return self._coords

    def _scatter_res(self, res, like):
        """(n_dof,) residual of per-element rows (nd entries, each a
        tensor, a float or None), summed to each variable's dofs."""
        r = like.new_zeros(self.asm.n_dof)
        res = [0.0 if x is None else x for x in res]
        if self.node:
            for vi, st in enumerate(self.starts):
                g = fe.scatter_rows(res[vi * 4:(vi + 1) * 4], QUAD_P1,
                                    self.dims, like)
                r[st:st + g.numel()] = g.reshape(-1)
        else:
            fe.scatter_dofs(res, r, self.starts, self.lattice, self.dims,
                            like, self.dof2fine)
        return r

    def _coord_eval(self, tc, sc, steady, alpha_u, alpha_t, jac_idx,
                    consts):
        """The state-independent part of the affine split (JAX's
        `_coord_eval`, plain torch on the element grid): the residual at
        the zero state (u_eval = beta_u, u_dot = beta_t; steady: 0) and
        the Jacobian rows, cached per stage and scalars, since a Newton
        solve does not move them."""
        if tc.is_steady:
            key, held = ("steady", sc), ()
        else:
            held = (tc.beta_u, tc.beta_t)
            key = (id(tc.beta_u), tc.beta_u._version, id(tc.beta_t),
                   tc.beta_t._version, alpha_u, alpha_t, sc)
        if self._stage_cache is not None and self._stage_cache[0] == key:
            return self._stage_cache[2]
        xyz = self._qp_coords()
        like = xyz[0][..., 0].reshape(-1)
        if steady:
            ue = ud = [[0.0] * self.nc for _ in range(self.nv)]
        else:
            ue = [fe.corner_values(g, self.lattice)
                  for g in self._grids(tc.beta_u)]
            ud = [fe.corner_values(g, self.lattice)
                  for g in self._grids(tc.beta_t)]
        density = _density(self.form,
                           lambda q: [c[..., q].reshape(-1) for c in xyz], sc)
        res, jac = accumulate_density(ue, ud, density, self.tables, alpha_u,
                                      alpha_t, steady)
        E = like.numel()
        varying = _stack_rows(jac, jac_idx, E, like)
        out = (self._scatter_res(res, like),
               rows_of(jac_idx, consts, varying, self.nd, self.asm.dtype,
                       self.asm.device))
        self._stage_cache = (key, held, out)
        return out

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
        split = self._detect_affine(steady)
        if split:
            jac0_idx, consts0, n_res0 = self._classify(
                sc, alpha_u, alpha_t, steady, "zero")
            split = jac0_idx == jac_idx
        stage = None if steady else Stage(alpha_u, alpha_t, None)
        geo = (self.origin, self.h_axes, self.q_off)
        if split:
            self._check_state_layout()
            n_lin = self._classify(sc, alpha_u, alpha_t, steady, "lin")[2]
            self.stats = {"steady": steady, "split": True,
                          "n_res_rows": n_lin, "n_jac_rows": 0,
                          "coord_res_rows": n_res0,
                          "coord_jac_rows": len(jac0_idx),
                          "node_scatter": self.node}
            r0, rows = self._coord_eval(tc, sc, steady, alpha_u, alpha_t,
                                        jac0_idx, consts0)
            grids = self._grids(u).contiguous()
            r = torch.zeros(asm.n_dof, dtype=u.dtype, device=u.device)
            if self.node:
                node = set_node_state(self.form, grids, sc, self.tables,
                                      geo, stage)
                for vi, st in enumerate(self.starts):
                    r[st:st + node[vi].numel()] = node[vi].reshape(-1)
            else:
                res = set_elem_state(self.form, grids, sc, self.tables,
                                     self.lattice, geo, stage)
                fe.scatter_dofs(res, r, self.starts, self.lattice,
                                self.dims, grids[0], self.dof2fine)
            return torch.where(asm.fixed, 0.0, r0 + r), rows
        self.stats = {"steady": steady, "split": False, "n_res_rows": n_res,
                      "n_jac_rows": len(jac_idx), "node_scatter": self.node}
        if steady:
            ue, ud = self._grids(u), None
        else:
            ue = self._grids(alpha_u * u + tc.beta_u)
            ud = self._grids(alpha_t * u + tc.beta_t).contiguous()
        ue = ue.contiguous()
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
