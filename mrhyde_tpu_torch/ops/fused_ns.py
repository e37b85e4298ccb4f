"""Fused assembly of Navier-Stokes on uniform structured meshes: the
node-scatter kernel for 2D p1 quads, and the element-tile kernel for 3D
hex (p1) and 2D p2 quads.

The port of the JAX package's `FusedP1Assembly` (mrhyde_tpu/ops/
fused_p1.py) for the Navier-Stokes module: dim + 1 variables (ux, uy[,
uz], pr), nd = (dim + 1) nc local dofs, steady calls and transient
stages. Convection and tau(|u|) make the weak form non-affine, so, as in
JAX, every assembly is ONE kernel call in mode "full": the residual of
all variables and the element-varying Jacobian rows. As JAX's `use_node`
does, 2D p1 (nd = 12) takes the node-scatter kernel B2, whose CUDA
kernel `ns_node_full` (`csrc/fused_p1_ns.cu`) scatters the residual to
the nodes itself; hex (nd = 32) and p2 quads (nd = 27) take the
element-tile kernel B1, whose CUDA kernel `ns_elem_full`
(`csrc/fused_elem_ns.cu`) writes per-element residual rows that the
provider scatters (ops/fused_elem.py `scatter_rows`). Both take any
quadrature: `ns_elem_full` holds fewer elements per block where 16 would
not fit the card's shared memory (hex at quadrature 6, Q = 64: 8 in
f64), and the provider refuses, with a clear error, a quadrature whose
one element would not fit either. The plain version
of both is the JAX package's `_accumulate` ported over the sparse dual
numbers of `sparse_dual.py`.

Row classification is JAX's `_probe`: `accumulate` runs on (2,)-shaped
stand-ins for every element-varying input (corner values, beta grids,
coefficients that read x, y or z) and a Jacobian entry is
element-varying iff it comes back as a tensor; the other entries' probe
values are exact for every element. A second probe with shifted
stand-ins must agree (JAX's double-probe cross-check), and the plain
versions check that no row the probe called constant comes back varying
(JAX's in-kernel assertion).

The coefficients (density, viscosity, source ux, source uy[, source
uz]) are Python floats when constant and (E, Q) tensors from a torch
pre-pass when they read the coordinates, as the thermal kernels take
theirs.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import BlockJacobian
from mrhyde_tpu_torch.ops import fused_elem as fe
from mrhyde_tpu_torch.ops._launch import (
    LAUNCHES, ElemArgs, check_err, check_smem, elem_smem_words, elem_tiles,
    ns_node_smem_words, stream)
from mrhyde_tpu_torch.ops.fused_p1 import (
    QUAD_P1, QpCtx, Stage, _check_grid, _scalar, params_key, qp_coords,
    steady_check, structured_geometry)
from mrhyde_tpu_torch.ops.sparse_dual import sparse_jacfwd
from mrhyde_tpu_torch.physics.navierstokes import ns_density
from mrhyde_tpu_torch.utils.profiling import timed

__all__ = ["FusedNSAssembly", "NSForm", "ns_node_full", "ns_node_full_plain",
           "ns_elem_full", "ns_elem_full_plain", "accumulate", "COEFFS"]

# the node-scatter kernel's element: 4 corners, 3 variables (ux, uy, pr)
NC, NV = 4, 3
ND = NC * NV                   # 12 local dofs
CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))
VARS = ("ux", "uy", "uz")
# the coefficients of a dim-D deck are the first 2 + dim
COEFFS = ("density", "viscosity", "source ux", "source uy", "source uz")
_COORD = {"x", "y", "z"}


class NSForm(NamedTuple):
    """What the weak form reads besides the state and the coefficients:
    the stabilisation switches, the element size h, the stage's time step
    and whether the deck is transient (C3 = 2 then, else 0)."""
    pspg: bool
    supg: bool
    h: float
    deltat: float
    transient: bool

    @property
    def tau_dt2(self):
        """(C3/dt)^2, the term of tau the kernel takes precomputed."""
        c3 = 2.0 if self.transient else 0.0
        return (c3 / self.deltat) ** 2


# ----------------------------------------------------------------------
# the weak form accumulation (JAX's FusedP1Assembly._accumulate, "full")
# ----------------------------------------------------------------------

def accumulate_density(ue, ud, density, tab, alpha_u, alpha_t, steady,
                       mode="full"):
    """(res, jac) of any qp density (JAX's `_accumulate`): flat lists of
    nd and nd*nd entries (nd = nv nc), each None (structural zero), a
    Python float (element-independent) or a tensor shaped like the inputs
    (element-varying). ue[v][c], ud[v][c]: values of local dof c of
    u_eval and u_dot per variable; density(q, u, ud, g) -> [S_v for v] +
    [F_v,d for v for d] at quadrature point q from the per-variable
    value, u_dot and gradient list. Row k = row nd + col, row = v nc + c,
    col = w nc + c'. mode "full": the residual and the Jacobian; "lin"
    (the affine split's state part, given the pure state alpha_u u,
    alpha_t u in ue, ud): the residual of the densities' directional
    derivative along the state, sum_k D_k z_k, and jac None."""
    Q, dim = tab.Q, tab.dim
    nv, nc = len(ue), len(ue[0])
    nd = nv * nc
    phi, grad, wts = tab.phi, tab.grad, tab.wts
    off_g = nv * (1 if steady else 2)
    res = [None] * nd
    jac = [None] * (nd * nd)

    def acc2(a, b):
        return b if a is None else a + b

    for q in range(Q):
        uq = [sum(phi[c][q] * ue[v][c] for c in range(nc))
              for v in range(nv)]
        udq = [sum(phi[c][q] * ud[v][c] for c in range(nc))
               for v in range(nv)]
        gq = [[sum(grad[c][q][d] * ue[v][c] for c in range(nc))
               for d in range(dim)] for v in range(nv)]
        z0 = (uq + ([] if steady else udq)
              + [gq[v][d] for v in range(nv) for d in range(dim)])

        def f(z):
            u_ = z[:nv]
            ud_ = [0.0] * nv if steady else z[nv:2 * nv]
            g_ = [[z[off_g + v * dim + d] for d in range(dim)]
                  for v in range(nv)]
            return density(q, u_, ud_, g_)

        out0, D = sparse_jacfwd(f, z0)
        w = float(wts[q])
        if mode == "lin":
            out = [None] * len(out0)
            for k, zk in enumerate(z0):
                for oi, dk in enumerate(D[k]):
                    if dk is not None:
                        out[oi] = acc2(out[oi], dk * zk)
            for vi in range(nv):
                for c in range(nc):
                    a = None
                    if out[vi] is not None:
                        a = acc2(a, phi[c][q] * out[vi])
                    for d in range(dim):
                        fd = out[nv + vi * dim + d]
                        if fd is not None:
                            a = acc2(a, grad[c][q][d] * fd)
                    if a is not None:
                        res[vi * nc + c] = acc2(res[vi * nc + c], w * a)
            continue
        for vi in range(nv):
            Sv = out0[vi]
            Fv = [out0[nv + vi * dim + d] for d in range(dim)]
            for c in range(nc):
                a = phi[c][q] * Sv
                for d in range(dim):
                    a = a + grad[c][q][d] * Fv[d]
                res[vi * nc + c] = acc2(res[vi * nc + c], w * a)
        for wi in range(nv):
            for cp in range(nc):
                Tcol = [None] * (nv * (1 + dim))
                pc = phi[cp][q]
                for oi in range(nv * (1 + dim)):
                    a = None
                    d1 = D[wi][oi]
                    if d1 is not None:
                        a = acc2(a, alpha_u * pc * d1)
                    if not steady:
                        d2 = D[nv + wi][oi]
                        if d2 is not None:
                            a = acc2(a, alpha_t * pc * d2)
                    for d in range(dim):
                        d3 = D[off_g + wi * dim + d][oi]
                        if d3 is not None:
                            a = acc2(a, alpha_u * grad[cp][q][d] * d3)
                    Tcol[oi] = a
                for vi in range(nv):
                    for c in range(nc):
                        a = None
                        if Tcol[vi] is not None:
                            a = acc2(a, phi[c][q] * Tcol[vi])
                        for d in range(dim):
                            tg = Tcol[nv + vi * dim + d]
                            if tg is not None:
                                a = acc2(a, grad[c][q][d] * tg)
                        if a is None:
                            continue
                        k = (vi * nc + c) * nd + wi * nc + cp
                        jac[k] = acc2(jac[k], w * a)
    return res, (None if mode == "lin" else jac)


def accumulate(ue, ud, coeff_at, tab, form, alpha_u, alpha_t, steady):
    """(res, jac) of the NS weak form (`accumulate_density` on
    `ns_density`). ue[v][c], ud[v][c]: values of local dof c of u_eval
    and u_dot per variable (ux, uy[, uz], pr); coeff_at(q) -> (rho, visc,
    [src per velocity]) at quadrature point q."""
    dim = tab.dim
    nv = len(ue)
    names = VARS[:dim] + ("pr",)

    def density(q, u_, ud_, g_):
        rho, visc, src = coeff_at(q)
        out = ns_density(u_[:dim], ud_[:dim], g_[:dim], u_[dim], g_[dim],
                         rho, visc, src, form.h, form.deltat,
                         form.transient, form.pspg, form.supg)
        S = [out[v][0] for v in names]
        F = [out[v][1] or [0.0] * dim for v in names]
        return S + [F[v][d] for v in range(nv) for d in range(dim)]
    return accumulate_density(ue, ud, density, tab, alpha_u, alpha_t,
                              steady)


def _is_varying(v):
    return isinstance(v, torch.Tensor) and v.dim() >= 1


def _coeff_fn(coeffs, shape):
    """coeff_at(q) over scalar-or-(E, Q) coefficients, each tensor's qp
    q viewed as `shape` (the shape of the corner values)."""
    def at(v, q):
        if isinstance(v, torch.Tensor):
            return v.view(*shape, -1)[..., q]
        return v

    def coeff_at(q):
        rho, visc, *src = (at(v, q) for v in coeffs)
        return rho, visc, src
    return coeff_at


def _check_classes(jac, jac_idx):
    """JAX's in-kernel assertion: no row the probe called constant (not
    in jac_idx) may come back varying."""
    wanted = set(jac_idx)
    for k, v in enumerate(jac):
        if k not in wanted and _is_varying(v):
            raise AssertionError(f"jac[{k}] probe/kernel class mismatch")


def classify_probes(probe):
    """(jac_idx, jac constants, n_res) from JAX's double probe:
    probe(salt) -> (res, jac) of the accumulation on (2,)-shaped
    stand-ins. An entry is element-varying iff it comes back as a
    tensor; a second probe with shifted stand-ins must agree, and the
    constants must not move with the stand-ins."""
    res1, jac1 = probe(0.0)
    res2, jac2 = probe(0.293)
    idx = [tuple(k for k, v in enumerate(p) if _is_varying(v))
           for p in (res1, jac1, res2, jac2)]
    if idx[0] != idx[2] or idx[1] != idx[3]:
        raise AssertionError(
            "fused-path probe classification depends on dummy values "
            f"(res {idx[0]} vs {idx[2]}; jac {idx[1]} vs {idx[3]})")
    for k, (a, b) in enumerate(zip(jac1, jac2)):
        if k not in idx[1] and a is not None and \
                abs(float(a) - float(b)) > 1e-6 * (1.0 + abs(float(a))):
            raise AssertionError(
                f"jac[{k}] classified constant but its probe value "
                "depends on element data")
    consts = [None if (k in idx[1] or v is None) else float(v)
              for k, v in enumerate(jac1)]
    return idx[1], consts, len(idx[0])


def rows_of(jac_idx, consts, jac, nd, dtype, device):
    """The nd*nd row entries: the kernel's varying rows, the probe's
    constants (one host-to-device copy) and None."""
    cvals = [c for c in consts if c is not None]
    ct = iter(torch.tensor(cvals, dtype=dtype, device=device).unbind(0)) \
        if cvals else iter(())
    pos = {k: i for i, k in enumerate(jac_idx)}
    rows = []
    for k in range(nd * nd):
        if k in pos:
            rows.append(jac[pos[k]])
        elif consts[k] is None:
            rows.append(None)
        else:
            rows.append(next(ct))
    return rows


class StageCache:
    """The JAX package's _steady_check, once per stage: a stage is its
    TimeCoeffs' beta tensors (identity and version, held here), alphas,
    time and time step."""

    def __init__(self):
        self._entry = None

    def is_steady(self, tc):
        if tc.is_steady:
            return True
        key = (id(tc.beta_u), tc.beta_u._version, id(tc.beta_t),
               tc.beta_t._version, float(tc.alpha_u), float(tc.alpha_t),
               float(tc.time), float(tc.deltat))
        if self._entry is None or self._entry[0] != key:
            self._entry = (key, (tc.beta_u, tc.beta_t), steady_check(tc))
        return self._entry[2]


def _stack_rows(entries, idx, E, like):
    """The entries at idx, each broadcast to (E,), stacked to (len(idx),
    E)."""
    rows = [torch.broadcast_to(torch.as_tensor(entries[k], dtype=like.dtype,
                                               device=like.device), like.shape)
            .reshape(E) for k in idx]
    return torch.stack(rows) if rows else like.new_zeros((0, E))


def ns_node_full_plain(ue, ud, coeffs, tab, form, jac_idx, stage=None):
    """(node residual (3, N0+1, N1+1), Jacobian rows (len(jac_idx), E)):
    the plain version of `ns_node_full`. ue, ud: (3, N0+1, N1+1) u_eval
    and u_dot grids (ud None when steady); coeffs: (density, viscosity,
    source ux, source uy), each a float or an (E, Q) tensor; jac_idx:
    the rows to return (row k = row*12 + col); stage: None (steady) or a
    Stage (alpha_u, alpha_t; its mass is unused)."""
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    views = [[g[oi:oi + N0, oj:oj + N1] for oi, oj in CORNERS] for g in ue]
    steady = stage is None
    dviews = [[0.0] * NC for _ in range(NV)] if steady else \
        [[g[oi:oi + N0, oj:oj + N1] for oi, oj in CORNERS] for g in ud]
    res, jac = accumulate(views, dviews, _coeff_fn(coeffs, (N0, N1)), tab,
                          form, 1.0 if steady else stage.alpha_u,
                          0.0 if steady else stage.alpha_t, steady)
    _check_classes(jac, jac_idx)
    node = torch.stack([fe.scatter_rows(res[vi * NC:(vi + 1) * NC], QUAD_P1,
                                        (N0, N1), ue) for vi in range(NV)])
    return node, _stack_rows(jac, jac_idx, N0 * N1, views[0][0])


def ns_elem_full_plain(ue, ud, coeffs, tab, lat, form, jac_idx,
                       stage=None):
    """(residual rows (nd, E), Jacobian rows (len(jac_idx), E)): the
    plain version of `ns_elem_full`. ue, ud: the (dim + 1, *grid) u_eval
    and u_dot grids of ux, uy[, uz], pr (ud None when steady), each a p1
    node grid or a p2 fine lattice that `lat` reads; coeffs: (density,
    viscosity, source ux, source uy[, source uz]), each a float or an
    (E, Q) tensor; jac_idx: the rows to return (row k = row*nd + col);
    stage: None (steady) or a Stage (alpha_u, alpha_t; its mass is
    unused)."""
    steady = stage is None
    views = [fe.corner_values(g, lat) for g in ue]
    E = views[0][0].numel()
    dviews = [[0.0] * len(lat.offsets) for _ in views] if steady else \
        [fe.corner_values(g, lat) for g in ud]
    res, jac = accumulate(views, dviews, _coeff_fn(coeffs, (E,)), tab, form,
                          1.0 if steady else stage.alpha_u,
                          0.0 if steady else stage.alpha_t, steady)
    _check_classes(jac, jac_idx)
    like = views[0][0]
    return (_stack_rows(res, range(len(res)), E, like),
            _stack_rows(jac, jac_idx, E, like))


# ----------------------------------------------------------------------
# the kernel wrapper
# ----------------------------------------------------------------------

class _NSArgs(ctypes.Structure):
    """The C side's NsArgs (csrc/fused_p1_ns.cu), field for field."""
    _fields_ = [("ue", ctypes.c_void_p), ("ud", ctypes.c_void_p),
                ("coef", ctypes.c_void_p * 4), ("coef0", ctypes.c_double * 4),
                ("phi", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("wts", ctypes.c_void_p), ("row_pos", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("jac", ctypes.c_void_p),
                ("alpha_u", ctypes.c_double), ("alpha_t", ctypes.c_double),
                ("h", ctypes.c_double), ("tau_dt2", ctypes.c_double),
                ("Q", ctypes.c_int), ("N0", ctypes.c_int),
                ("N1", ctypes.c_int), ("pspg", ctypes.c_int),
                ("supg", ctypes.c_int), ("transient", ctypes.c_int)]


_ROW_POS = {}


def _row_pos(jac_idx, nd, device):
    """(nd*nd,) int32 device map row k -> its position in jac, or -1."""
    key = (tuple(jac_idx), nd, str(device))
    if key not in _ROW_POS:
        pos = np.full(nd * nd, -1, dtype=np.int32)
        pos[list(jac_idx)] = np.arange(len(jac_idx), dtype=np.int32)
        _ROW_POS[key] = torch.as_tensor(pos, device=device)
    return _ROW_POS[key]


def _check_grid_stacks(ue, ud, stage):
    """A steady call takes no u_dot grids, a stage takes them shaped,
    typed and placed like ue, and both contiguous."""
    if (stage is None) != (ud is None):
        raise ValueError("a stage takes the u_dot grids, a steady call none")
    if not ue.is_contiguous():
        raise ValueError("ue must be contiguous")
    if ud is not None and (ud.shape != ue.shape or ud.dtype != ue.dtype
                           or ud.device != ue.device
                           or not ud.is_contiguous()):
        raise ValueError("ud must be a contiguous grid stack like ue")


def _coeff_args(args, coeffs, E, Q, like):
    """Fill args.coef / args.coef0 from scalar-or-(E, Q) coefficients."""
    for i, v in enumerate(coeffs):
        if isinstance(v, torch.Tensor):
            if v.shape != (E, Q) or v.dtype != like.dtype \
                    or v.device != like.device or not v.is_contiguous():
                raise ValueError(f"{COEFFS[i]} must be a contiguous "
                                 f"({E}, {Q}) {like.dtype} tensor on "
                                 f"{like.device}")
            args.coef[i] = v.data_ptr()
        else:
            args.coef[i] = None
            args.coef0[i] = float(v)


def _ns_node_args(ue, ud, coeffs, tab, form, jac_idx, stage):
    """(_NSArgs, node residual, Jacobian rows, keep-alive) of one
    ns_node_full call: the checks of its inputs, the C struct filled from
    them and the outputs it points to, allocated on ue's device."""
    if ue.dim() != 3 or ue.shape[0] != NV:
        raise ValueError("ue must be a (3, N0+1, N1+1) grid stack")
    _check_grid_stacks(ue, ud, stage)
    steady = stage is None
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    E = N0 * N1
    args = _NSArgs()
    args.ue = ue.data_ptr()
    args.ud = None if ud is None else ud.data_ptr()
    _coeff_args(args, coeffs, E, tab.Q, ue)
    args.phi, args.grad, args.wts = (tab.t_phi.data_ptr(),
                                     tab.t_grad.data_ptr(),
                                     tab.t_wts.data_ptr())
    pos = _row_pos(jac_idx, ND, ue.device)
    args.row_pos = pos.data_ptr()
    out = torch.empty_like(ue)
    jac = torch.empty((len(jac_idx), E), dtype=ue.dtype, device=ue.device)
    args.res, args.jac = out.data_ptr(), jac.data_ptr()
    args.alpha_u = 1.0 if steady else float(stage.alpha_u)
    args.alpha_t = 0.0 if steady else float(stage.alpha_t)
    args.h, args.tau_dt2 = float(form.h), float(form.tau_dt2)
    args.Q, args.N0, args.N1 = tab.Q, N0, N1
    args.pspg, args.supg = int(form.pspg), int(form.supg)
    args.transient = int(not steady)
    return args, out, jac, pos


def ns_node_full(ue, ud, coeffs, tab, form, jac_idx, stage=None):
    """(node residual (3, N0+1, N1+1), Jacobian rows (len(jac_idx), E))
    of the NS weak form: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Arguments as `ns_node_full_plain`."""
    if ue.device.type == "cpu":
        return ns_node_full_plain(ue, ud, coeffs, tab, form, jac_idx, stage)
    args, out, jac, _keep = _ns_node_args(ue, ud, coeffs, tab, form,
                                          jac_idx, stage)
    _check_grid(ue[0], tab)
    from mrhyde_tpu_torch.ops._build import load_library
    lib = load_library()
    fn = (lib.ns_node_full_f64 if ue.dtype == torch.float64
          else lib.ns_node_full_f32)
    check_err("ns_node_full",
              fn(ctypes.c_void_p(ctypes.addressof(args)), stream(ue)), tab.Q)
    LAUNCHES["ns_full"] += 1
    return out, jac


def _ns_elem_args(ue, ud, coeffs, tab, lat, form, jac_idx, stage):
    """(ElemArgs, residual rows, Jacobian rows, keep-alive) of one
    ns_elem_full call: the C struct filled from the arguments, and the
    outputs it points to, allocated on ue's device."""
    nv = tab.dim + 1
    if ue.dim() != tab.dim + 1 or ue.shape[0] != nv:
        raise ValueError(f"ue must be a ({nv}, *grid) stack of the "
                         f"variables' grids")
    _check_grid_stacks(ue, ud, stage)
    if len(coeffs) != 2 + tab.dim:
        raise ValueError(f"a {tab.dim}-D call takes {2 + tab.dim} "
                         f"coefficients, not {len(coeffs)}")
    steady = stage is None
    nc = len(lat.offsets)
    nd = nv * nc
    dims = list(fe.elem_dims(ue[0], lat)) + [1] * (3 - tab.dim)
    E = math.prod(dims)
    args = ElemArgs()
    args.ue = ue.data_ptr()
    args.ud = None if ud is None else ud.data_ptr()
    _coeff_args(args, coeffs, E, tab.Q, ue)
    args.phi, args.grad, args.wts = (tab.t_phi.data_ptr(),
                                     tab.t_grad.data_ptr(),
                                     tab.t_wts.data_ptr())
    pos = _row_pos(jac_idx, nd, ue.device)
    tiles = elem_tiles(jac_idx, nv, nc, ue.device)
    args.row_pos = pos.data_ptr()
    args.tiles, args.n_tiles = tiles.data_ptr(), tiles.numel()
    res = torch.empty((nd, E), dtype=ue.dtype, device=ue.device)
    jac = torch.empty((len(jac_idx), E), dtype=ue.dtype, device=ue.device)
    args.res, args.jac = res.data_ptr(), jac.data_ptr()
    args.alpha_u = 1.0 if steady else float(stage.alpha_u)
    args.alpha_t = 0.0 if steady else float(stage.alpha_t)
    args.h, args.tau_dt2 = float(form.h), float(form.tau_dt2)
    args.Q, args.nc, args.dim, args.stride = tab.Q, nc, tab.dim, lat.stride
    args.N0, args.N1, args.N2 = dims
    args.pspg, args.supg = int(form.pspg), int(form.supg)
    args.transient = int(not steady)
    for c, off in enumerate(lat.offsets):
        for a, o in enumerate(off):
            args.off[c][a] = int(o)
    return args, res, jac, (pos, tiles)


def ns_elem_full(ue, ud, coeffs, tab, lat, form, jac_idx, stage=None):
    """(residual rows (nd, E), Jacobian rows (len(jac_idx), E)) of the NS
    weak form on hex p1 or p2 quads: the CUDA kernel on CUDA tensors, the
    plain version on CPU tensors. Arguments as `ns_elem_full_plain`."""
    if ue.device.type == "cpu":
        return ns_elem_full_plain(ue, ud, coeffs, tab, lat, form, jac_idx,
                                  stage)
    fe._check_grid(ue[0], tab, lat)
    args, res, jac, _keep = _ns_elem_args(ue, ud, coeffs, tab, lat, form,
                                          jac_idx, stage)
    from mrhyde_tpu_torch.ops._build import load_library
    lib = load_library()
    fn = (lib.ns_elem_full_f64 if ue.dtype == torch.float64
          else lib.ns_elem_full_f32)
    err = fn(ctypes.c_void_p(ctypes.addressof(args)), stream(ue))
    check_err("ns_elem_full", err, tab.Q)
    LAUNCHES["ns_elem_full"] += 1
    return res, jac


# ----------------------------------------------------------------------
# the provider
# ----------------------------------------------------------------------

def _dummy(seed, s, dtype):
    # arbitrary distinct values (JAX's _probe): only the tensor-ness of
    # what comes back matters, and the constants must not depend on them
    return torch.tensor([0.37 + 0.11 * seed + s, 0.81 + 0.07 * seed + s],
                        dtype=dtype)


class FusedNSAssembly:
    """Fused residual+Jacobian provider for Navier-Stokes on uniform
    structured meshes, steady calls and transient stages alike: 2D p1
    quads through `ns_node_full` (B2), 3D p1 hex and 2D all-p2 quads
    through `ns_elem_full` (B1), as the JAX package's `use_node` picks.
    `FusedNSAssembly.build(asm)` -> instance or None; decks the JAX
    package would fuse but this provider cannot raise."""

    def __init__(self, asm):
        self.asm = asm
        geo = structured_geometry(asm)
        self.dims, self.origin, self.h_axes, self.q_off, self.tables = geo
        self.dim = len(self.dims)
        s = asm._structured
        kind = s["plan"][0][0]
        self.vars = [name for (_k, name, _st) in s["plan"]]
        starts = [st for (_k, _n, st) in s["plan"]]
        self.nv = self.dim + 1
        if self.vars != [*VARS[:self.dim], "pr"]:
            raise AssertionError(f"NS variables are {self.vars}, not "
                                 f"{[*VARS[:self.dim], 'pr']}")
        # the JAX package's use_node: 2D p1 takes B2, the rest B1
        self.node = self.dim == 2 and kind == "p1"
        (self.lattice, self.grid_shape, self.fine_idx,
         self.dof2fine) = fe.structured_lattice(asm, self.dims, starts)
        ng = math.prod(self.grid_shape)
        if kind == "p1" and starts != [starts[0] + i * ng
                                       for i in range(self.nv)]:
            raise AssertionError("NS variables are not in consecutive "
                                 "node-grid blocks")
        self.starts = starts
        self.start = starts[0]
        self.nc = len(self.lattice.offsets)
        self.nd = self.nv * self.nc
        if not self.node:
            # ns_elem_full's layout at this quadrature (the larger, a
            # stage's, where the deck is transient)
            tr, Q = asm.is_transient, self.tables.Q
            check_smem("ns_elem_full", lambda el: elem_smem_words(
                self.dim, self.nc, self.nv, tr, Q, el),
                asm.dtype.itemsize, Q)
        else:
            # ns_node_full's block at this quadrature: its halo's densities
            Q = self.tables.Q
            check_smem("ns_node_full", lambda _el: ns_node_smem_words(Q),
                       asm.dtype.itemsize, Q)
        self.module = asm.modules[0]
        # the element size (sum of the weights)^(1/dim), as the JAX
        # package's h_elem and the workset's h
        self.h = float(np.sum(self.tables.wts) ** (1.0 / self.dim))
        self.coeff_names = COEFFS[:2 + self.dim]
        # a coefficient varies by element where it reads the
        # coordinates or another set's field (a multi-set deck)
        self.varying = tuple(
            bool(asm.fm.terminal_leaves(n) & (_COORD | asm.field_leaves))
            for n in self.coeff_names)
        self._probes = {}
        self._coef_cache = None
        self._stage = StageCache()
        self.stats = {"steady": True, "split": False, "n_res_rows": self.nd,
                      "n_jac_rows": 0, "node_scatter": self.node}

    @staticmethod
    def build(asm):
        """The NS provider of a qualifying deck; the module-set provider
        (ops/fused_set.py) for NS in a set or with a coefficient that
        reads the state; None where the deck takes the general path, as
        an NS coefficient that reads a gradient, a time derivative or z
        in 2D does (the JAX package's default path)."""
        disc = asm.disc
        cell = disc.mesh.cell_type
        s = asm._structured
        if s is None or not asm.uniform or asm.general_only:
            return None             # the JAX package's general path too
        # all-p1 quads or hex, or all-p2 quads (the uniform row layout)
        kinds = {k for (k, _n, _st) in s["plan"]}
        if not (kinds == {"p1"} and cell in ("quad", "hex")
                or kinds == {"p2"} and cell == "quad"):
            return None
        # NS in a set, or a coefficient that reads the state: the
        # module-set provider
        in_set = len(asm.modules) != 1
        for name in COEFFS[:2 + len(s["dims"])]:
            for leaf in asm.fm.terminal_leaves(name):
                if leaf.startswith("grad(") or (
                        leaf.endswith("_t") and leaf[:-2] in disc.var_names) \
                        or (leaf == "z" and cell == "quad"):
                    return None
                in_set = in_set or leaf in disc.var_names
        if not in_set:
            return FusedNSAssembly(asm)
        from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
        return FusedSetAssembly.build(asm)

    # ------------------------------------------------------------------

    def _grids(self, v):
        """The (dim + 1, *grid) grids of ux, uy[, uz], pr in a dof vector:
        consecutive node-grid blocks (p1), or one gather of the fine
        lattices (p2)."""
        if self.fine_idx is not None:
            return v[self.fine_idx]
        n = math.prod(self.grid_shape)
        return v[self.start:self.start + self.nv * n].reshape(
            self.nv, *self.grid_shape)

    def _form(self, tc):
        m = self.module
        return NSForm(m.use_pspg, m.use_supg, self.h, float(tc.deltat),
                      bool(self.asm.is_transient))

    def _coefficients(self, time, params):
        """(density, viscosity, source ux, source uy[, source uz]): Python
        floats, or (E, Q) tensors for the ones that read the coordinates;
        cached per (time, params)."""
        key = (float(time), params_key(params))
        if self._coef_cache is not None and self._coef_cache[0] == key:
            return self._coef_cache[1]
        coords = None
        out = []
        for name, var in zip(self.coeff_names, self.varying):
            if var:
                if coords is None:
                    coords = qp_coords(self.dims, self.origin, self.h_axes,
                                       self.q_off, self.tables.Q,
                                       self.asm.dtype, self.asm.device)
                ctx = QpCtx(None, 0.0, coords, float(time), params,
                            self.asm.fm)
                v = torch.broadcast_to(torch.as_tensor(
                    ctx.f(name), dtype=self.asm.dtype,
                    device=self.asm.device), coords[0].shape)
                out.append(v.reshape(-1, self.tables.Q).contiguous())
            else:
                ctx = QpCtx(None, 0.0, None, float(time), params,
                            self.asm.fm)
                out.append(_scalar(ctx.f(name)))
        # params are held too: a field's key is its identity
        self._coef_cache = (key, tuple(out), params)
        return self._coef_cache[1]

    def _probe(self, coeffs, form, alpha_u, alpha_t, steady, salt):
        """JAX's _probe: accumulate on (2,)-shaped stand-ins, on the CPU."""
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
        cs = [_dummy(k + i, salt, dt) if isinstance(v, torch.Tensor) else v
              for i, v in enumerate(coeffs)]

        def coeff_at(_q):
            return cs[0], cs[1], cs[2:]
        return accumulate(ue, ud, coeff_at, self.tables, form, alpha_u,
                          alpha_t, steady)

    def _classify(self, coeffs, form, alpha_u, alpha_t, steady):
        """(jac_idx, jac constants) of a call, cached per its scalars."""
        key = (steady, alpha_u, alpha_t, form,
               tuple(None if isinstance(v, torch.Tensor) else v
                     for v in coeffs))
        if key not in self._probes:
            self._probes[key] = classify_probes(
                lambda salt: self._probe(coeffs, form, alpha_u, alpha_t,
                                         steady, salt=salt))
        return self._probes[key]

    def res_jac(self, u, tc, pvec=None):
        """(residual (n_dof,), Jacobian rows: list of nd*nd entries, each
        None, a 0-d tensor or an (E,) tensor)."""
        asm = self.asm
        params = dict(asm.params)
        params.update({k: v if str(k).startswith("__field:") else float(v)
                       for k, v in (pvec or {}).items()})
        steady = self._stage.is_steady(tc)
        alpha_u = 1.0 if steady else float(tc.alpha_u)
        alpha_t = 0.0 if steady else float(tc.alpha_t)
        form = self._form(tc)
        # the coefficients at the quadrature points and the rows' classes
        with timed("assembly::coefficients"):
            coeffs = self._coefficients(tc.time, params)
            jac_idx, consts, n_res = self._classify(coeffs, form, alpha_u,
                                                    alpha_t, steady)
        self.stats = {"steady": steady, "split": False, "n_res_rows": n_res,
                      "n_jac_rows": len(jac_idx), "node_scatter": self.node}
        if steady:
            ue, ud, stage = self._grids(u), None, None
        else:
            ue = self._grids(alpha_u * u + tc.beta_u)
            ud = self._grids(alpha_t * u + tc.beta_t)
            stage = Stage(alpha_u, alpha_t, None)
        ue = ue.contiguous()
        ud = ud if ud is None else ud.contiguous()
        r = torch.zeros(asm.n_dof, dtype=u.dtype, device=u.device)
        with timed("assembly::kernel"):
            if self.node:
                node, jac = ns_node_full(ue, ud, coeffs, self.tables, form,
                                         jac_idx, stage)
                r[self.start:self.start + node.numel()] = node.reshape(-1)
            else:
                res, jac = ns_elem_full(ue, ud, coeffs, self.tables,
                                        self.lattice, form, jac_idx, stage)
                fe.scatter_dofs(res, r, self.starts, self.lattice,
                                self.dims, ue[0], self.dof2fine)
        # the Jacobian's SoA rows: the kernel's, and the constant ones
        with timed("assembly::jacobian"):
            rows = rows_of(jac_idx, consts, jac, self.nd, asm.dtype,
                           asm.device)
        return torch.where(asm.fixed, 0.0, r), rows

    def jacobian(self, u, tc, pvec=None):
        """(residual, BlockJacobian) with the kernel's SoA row layout."""
        r, rows = self.res_jac(u, tc, pvec)
        return r, BlockJacobian(vol=None, vol_lids=self.asm.lids,
                                fixed=self.asm.fixed, inc=self.asm.inc,
                                vol_soa=rows)
