"""Fused node-scatter assembly for 2D Navier-Stokes on uniform p1 quads.

The port of the JAX package's `FusedP1Assembly` (mrhyde_tpu/ops/
fused_p1.py) for the Navier-Stokes module: three variables (ux, uy, pr),
nd = 12 local dofs, steady calls and transient stages. Convection and
tau(|u|) make the weak form non-affine, so, as in JAX, every assembly is
ONE call of the node-scatter kernel B2 in mode "full": the
node-scattered residual of all three variables and the element-varying
Jacobian rows. Its CUDA kernel is `ns_node_full` (`csrc/
fused_p1_ns.cu`); its plain version is the JAX package's `_accumulate`
ported over the sparse dual numbers of `sparse_dual.py`, followed by the
pad+sum node scatter.

Row classification is JAX's `_probe`: `accumulate` runs on (2,)-shaped
stand-ins for every element-varying input (corner values, beta grids,
coefficients that read x or y) and a Jacobian entry is element-varying
iff it comes back as a tensor; the other entries' probe values are
exact for every element. A second probe with shifted stand-ins must
agree (JAX's double-probe cross-check), and the plain version checks
that no row the probe called constant comes back varying (JAX's
in-kernel assertion).

The coefficients (density, viscosity, source ux, source uy) are Python
floats when constant and (E, Q) tensors from a torch pre-pass when they
read x or y, as the thermal kernels take theirs.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import BlockJacobian
from mrhyde_tpu_torch.ops._launch import LAUNCHES, stream
from mrhyde_tpu_torch.ops.fused_elem import scatter_rows
from mrhyde_tpu_torch.ops.fused_p1 import (
    QUAD_P1, QpCtx, Stage, _check_grid, _scalar, qp_coords, steady_check,
    structured_geometry)
from mrhyde_tpu_torch.ops.sparse_dual import sparse_jacfwd
from mrhyde_tpu_torch.physics.navierstokes import (NS_REMAINDER,
                                                   NavierStokes, ns_density)

__all__ = ["FusedNSAssembly", "NSForm", "ns_node_full", "ns_node_full_plain",
           "accumulate", "COEFFS"]

NC, NV = 4, 3                  # corners, variables (ux, uy, pr)
ND = NC * NV                   # 12 local dofs
CORNERS = ((0, 0), (1, 0), (1, 1), (0, 1))
COEFFS = ("density", "viscosity", "source ux", "source uy")
_COORD = {"x", "y"}


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

def accumulate(ue, ud, coeff_at, tab, form, alpha_u, alpha_t, steady):
    """(res, jac): flat lists of ND and ND*ND entries, each None
    (structural zero), a Python float (element-independent) or a tensor
    shaped like the inputs (element-varying). ue[v][c], ud[v][c]: corner
    values of u_eval and u_dot per variable; coeff_at(q) -> (rho, visc,
    [src_x, src_y]) at quadrature point q."""
    Q, dim = tab.Q, 2
    phi, grad, wts = tab.phi, tab.grad, tab.wts
    n_in = NV * ((1 if steady else 2) + dim)
    off_g = NV * (1 if steady else 2)
    res = [None] * ND
    jac = [None] * (ND * ND)

    def acc2(a, b):
        return b if a is None else a + b

    for q in range(Q):
        uq = [sum(phi[c][q] * ue[v][c] for c in range(NC))
              for v in range(NV)]
        udq = [sum(phi[c][q] * ud[v][c] for c in range(NC))
               for v in range(NV)]
        gq = [[sum(grad[c][q][d] * ue[v][c] for c in range(NC))
               for d in range(dim)] for v in range(NV)]
        rho, visc, src = coeff_at(q)
        z0 = (uq + ([] if steady else udq)
              + [gq[v][d] for v in range(NV) for d in range(dim)])

        def f(z):
            u_ = z[:NV]
            ud_ = [0.0] * NV if steady else z[NV:2 * NV]
            g_ = [[z[off_g + v * dim + d] for d in range(dim)]
                  for v in range(NV)]
            out = ns_density(u_[:2], ud_[:2], g_[:2], u_[2], g_[2], rho,
                             visc, src, form.h, form.deltat,
                             form.transient, form.pspg, form.supg)
            S = [out[v][0] for v in ("ux", "uy", "pr")]
            F = [out[v][1] or [0.0, 0.0] for v in ("ux", "uy", "pr")]
            return S + [F[v][d] for v in range(NV) for d in range(dim)]

        out0, D = sparse_jacfwd(f, z0)
        w = float(wts[q])
        for vi in range(NV):
            Sv = out0[vi]
            Fv = [out0[NV + vi * dim + d] for d in range(dim)]
            for c in range(NC):
                a = phi[c][q] * Sv
                for d in range(dim):
                    a = a + grad[c][q][d] * Fv[d]
                res[vi * NC + c] = acc2(res[vi * NC + c], w * a)
        for wi in range(NV):
            for cp in range(NC):
                Tcol = [None] * (NV * (1 + dim))
                pc = phi[cp][q]
                for oi in range(NV * (1 + dim)):
                    a = None
                    d1 = D[wi][oi]
                    if d1 is not None:
                        a = acc2(a, alpha_u * pc * d1)
                    if not steady:
                        d2 = D[NV + wi][oi]
                        if d2 is not None:
                            a = acc2(a, alpha_t * pc * d2)
                    for d in range(dim):
                        d3 = D[off_g + wi * dim + d][oi]
                        if d3 is not None:
                            a = acc2(a, alpha_u * grad[cp][q][d] * d3)
                    Tcol[oi] = a
                for vi in range(NV):
                    for c in range(NC):
                        a = None
                        if Tcol[vi] is not None:
                            a = acc2(a, phi[c][q] * Tcol[vi])
                        for d in range(dim):
                            tg = Tcol[NV + vi * dim + d]
                            if tg is not None:
                                a = acc2(a, grad[c][q][d] * tg)
                        if a is None:
                            continue
                        k = (vi * NC + c) * ND + wi * NC + cp
                        jac[k] = acc2(jac[k], w * a)
    return res, jac


def _is_varying(v):
    return isinstance(v, torch.Tensor) and v.dim() >= 1


def _coeff_fn(coeffs, dims):
    """coeff_at(q) over scalar-or-(E, Q) coefficients."""
    def at(v, q):
        if isinstance(v, torch.Tensor):
            return v.view(dims[0], dims[1], -1)[:, :, q]
        return v

    def coeff_at(q):
        rho, visc, sx, sy = (at(v, q) for v in coeffs)
        return rho, visc, [sx, sy]
    return coeff_at


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
    wanted = set(jac_idx)
    for k, v in enumerate(jac):
        if k not in wanted and _is_varying(v):
            raise AssertionError(f"jac[{k}] probe/kernel class mismatch")
    node = torch.stack([scatter_rows(res[vi * NC:(vi + 1) * NC], QUAD_P1,
                                     (N0, N1), ue) for vi in range(NV)])
    E = N0 * N1
    rows = [torch.broadcast_to(torch.as_tensor(jac[k], dtype=ue.dtype,
                                               device=ue.device), (N0, N1))
            .reshape(E) for k in jac_idx]
    jac_out = torch.stack(rows) if rows else ue.new_zeros((0, E))
    return node, jac_out


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


def _row_pos(jac_idx, device):
    """(144,) int32 device map row k -> its position in jac, or -1."""
    key = (tuple(jac_idx), str(device))
    if key not in _ROW_POS:
        pos = np.full(ND * ND, -1, dtype=np.int32)
        pos[list(jac_idx)] = np.arange(len(jac_idx), dtype=np.int32)
        _ROW_POS[key] = torch.as_tensor(pos, device=device)
    return _ROW_POS[key]


def ns_node_full(ue, ud, coeffs, tab, form, jac_idx, stage=None):
    """(node residual (3, N0+1, N1+1), Jacobian rows (len(jac_idx), E))
    of the NS weak form: the CUDA kernel on CUDA tensors, the plain
    version on CPU tensors. Arguments as `ns_node_full_plain`."""
    if ue.device.type == "cpu":
        return ns_node_full_plain(ue, ud, coeffs, tab, form, jac_idx, stage)
    if ue.dim() != 3 or ue.shape[0] != NV:
        raise ValueError("ue must be a (3, N0+1, N1+1) grid stack")
    _check_grid(ue[0], tab)
    if not ue.is_contiguous():
        raise ValueError("ue must be contiguous")
    steady = stage is None
    if steady != (ud is None):
        raise ValueError("a stage takes the u_dot grids, a steady call none")
    if ud is not None and (ud.shape != ue.shape or ud.dtype != ue.dtype
                           or ud.device != ue.device
                           or not ud.is_contiguous()):
        raise ValueError("ud must be a contiguous grid stack like ue")
    N0, N1 = ue.shape[1] - 1, ue.shape[2] - 1
    E = N0 * N1
    args = _NSArgs()
    args.ue = ue.data_ptr()
    args.ud = None if ud is None else ud.data_ptr()
    for i, v in enumerate(coeffs):
        if isinstance(v, torch.Tensor):
            if v.shape != (E, tab.Q) or v.dtype != ue.dtype \
                    or v.device != ue.device or not v.is_contiguous():
                raise ValueError(f"{COEFFS[i]} must be a contiguous "
                                 f"({E}, {tab.Q}) {ue.dtype} tensor on "
                                 f"{ue.device}")
            args.coef[i] = v.data_ptr()
        else:
            args.coef[i] = None
            args.coef0[i] = float(v)
    args.phi, args.grad, args.wts = (tab.t_phi.data_ptr(),
                                     tab.t_grad.data_ptr(),
                                     tab.t_wts.data_ptr())
    args.row_pos = _row_pos(jac_idx, ue.device).data_ptr()
    out = torch.empty_like(ue)
    jac = torch.empty((len(jac_idx), E), dtype=ue.dtype, device=ue.device)
    args.res, args.jac = out.data_ptr(), jac.data_ptr()
    args.alpha_u = 1.0 if steady else float(stage.alpha_u)
    args.alpha_t = 0.0 if steady else float(stage.alpha_t)
    args.h, args.tau_dt2 = float(form.h), float(form.tau_dt2)
    args.Q, args.N0, args.N1 = tab.Q, N0, N1
    args.pspg, args.supg = int(form.pspg), int(form.supg)
    args.transient = int(not steady)
    from mrhyde_tpu_torch.ops._build import load_library
    lib = load_library()
    fn = (lib.ns_node_full_f64 if ue.dtype == torch.float64
          else lib.ns_node_full_f32)
    err = fn(ctypes.c_void_p(ctypes.addressof(args)), stream(ue))
    if err != 0:
        raise RuntimeError(f"ns_node_full launch failed: CUDA error {err}")
    LAUNCHES["ns_full"] += 1
    return out, jac


# ----------------------------------------------------------------------
# the provider
# ----------------------------------------------------------------------

def _dummy(seed, s, dtype):
    # arbitrary distinct values (JAX's _probe): only the tensor-ness of
    # what comes back matters, and the constants must not depend on them
    return torch.tensor([0.37 + 0.11 * seed + s, 0.81 + 0.07 * seed + s],
                        dtype=dtype)


class FusedNSAssembly:
    """Fused residual+Jacobian provider for 2D Navier-Stokes on uniform
    structured p1 quads, steady calls and transient stages alike.
    `FusedNSAssembly.build(asm)` -> instance or None; decks the JAX
    package would fuse but this provider cannot raise."""

    def __init__(self, asm):
        self.asm = asm
        geo = structured_geometry(asm)
        self.dims, self.origin, self.h_axes, self.q_off, self.tables = geo
        s = asm._structured
        self.vars = [name for (_k, name, _st) in s["plan"]]
        starts = [st for (_k, _n, st) in s["plan"]]
        ng = (self.dims[0] + 1) * (self.dims[1] + 1)
        if self.vars != ["ux", "uy", "pr"] or starts != [
                starts[0] + i * ng for i in range(NV)]:
            raise AssertionError("NS variables are not ux, uy, pr in "
                                 "consecutive node-grid blocks")
        self.start = starts[0]
        self.module = asm.modules[0]
        self.h = float(np.sum(self.tables.wts) ** 0.5)
        self.varying = tuple(bool(asm.fm.terminal_leaves(n) & _COORD)
                             for n in COEFFS)
        self._probes = {}
        self._coef_cache = None
        self._steady_cache = None
        self.stats = {"steady": True, "split": False, "n_res_rows": ND,
                      "n_jac_rows": 0, "node_scatter": True}

    @staticmethod
    def build(asm):
        if len(asm.modules) != 1:
            names = [m.name for m in asm.modules]
            if "thermal" in names:
                NavierStokes.reject_energy()
            raise NotImplementedError(
                f"navier stokes with other modules ({names}) is not ported "
                f"to mrhyde_tpu_torch yet (ROADMAP {NS_REMAINDER})")
        disc = asm.disc
        mesh = disc.mesh
        keys = set(disc.basis_keys.values())
        if getattr(mesh, "box_info", None) is not None \
                and mesh.cell_type in ("quad", "hex") \
                and (mesh.cell_type == "hex" or keys == {("HGRAD", 2)}):
            raise NotImplementedError(
                "the fused Navier-Stokes assembly of 3D hex or p2 quad "
                "meshes is B1 for Navier-Stokes (the element-tile kernel), "
                "not ported to mrhyde_tpu_torch yet (ROADMAP B1; order "
                "item 2)")
        if asm._structured is None or mesh.cell_type != "quad" \
                or not asm._structured["general"] or not asm.uniform:
            return None             # the JAX package's general path too
        for name in COEFFS:
            for leaf in asm.fm.terminal_leaves(name):
                state = (leaf in disc.var_names or leaf.startswith("grad(")
                         or (leaf.endswith("_t")
                             and leaf[:-2] in disc.var_names))
                if state or leaf == "z":
                    raise NotImplementedError(
                        f"the NS coefficient {name!r} reads {leaf!r}: "
                        "state- and z-dependent NS coefficients are not "
                        "ported to mrhyde_tpu_torch yet (ROADMAP "
                        f"{NS_REMAINDER})")
        return FusedNSAssembly(asm)

    # ------------------------------------------------------------------

    def _grids(self, v):
        """The (3, N0+1, N1+1) node grids of ux, uy, pr in a dof vector."""
        N0, N1 = self.dims
        ng = (N0 + 1) * (N1 + 1)
        return v[self.start:self.start + NV * ng].reshape(NV, N0 + 1, N1 + 1)

    def _form(self, tc):
        m = self.module
        return NSForm(m.use_pspg, m.use_supg, self.h, float(tc.deltat),
                      bool(self.asm.is_transient))

    def _is_steady(self, tc):
        """The JAX package's _steady_check, once per stage: a stage is its
        TimeCoeffs' beta tensors (identity and version, held here),
        alphas, time and time step."""
        if tc.is_steady:
            return True
        key = (id(tc.beta_u), tc.beta_u._version, id(tc.beta_t),
               tc.beta_t._version, float(tc.alpha_u), float(tc.alpha_t),
               float(tc.time), float(tc.deltat))
        if self._steady_cache is None or self._steady_cache[0] != key:
            self._steady_cache = (key, (tc.beta_u, tc.beta_t),
                                  steady_check(tc))
        return self._steady_cache[2]

    def _coefficients(self, time, params):
        """(density, viscosity, source ux, source uy): Python floats, or
        (E, Q) tensors for the ones that read x or y; cached per (time,
        params)."""
        key = (float(time), tuple(sorted((k, float(v))
                                         for k, v in params.items())))
        if self._coef_cache is not None and self._coef_cache[0] == key:
            return self._coef_cache[1]
        coords = None
        out = []
        for name, var in zip(COEFFS, self.varying):
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
        self._coef_cache = (key, tuple(out))
        return self._coef_cache[1]


    def _probe(self, coeffs, form, alpha_u, alpha_t, steady, salt):
        """JAX's _probe: accumulate on (2,)-shaped stand-ins, on the CPU."""
        dt = self.asm.dtype
        ue, ud = [], []
        k = 0
        for _v in range(NV):
            ue.append([])
            ud.append([])
            for _c in range(NC):
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
            return cs[0], cs[1], [cs[2], cs[3]]
        return accumulate(ue, ud, coeff_at, self.tables, form, alpha_u,
                          alpha_t, steady)

    def _classify(self, coeffs, form, alpha_u, alpha_t, steady):
        """(jac_idx, jac constants) of a call, cached per its scalars."""
        key = (steady, alpha_u, alpha_t, form,
               tuple(None if isinstance(v, torch.Tensor) else v
                     for v in coeffs))
        if key in self._probes:
            return self._probes[key]
        args = (coeffs, form, alpha_u, alpha_t, steady)
        res1, jac1 = self._probe(*args, salt=0.0)
        res2, jac2 = self._probe(*args, salt=0.293)
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
        self._probes[key] = (idx[1], consts, len(idx[0]))
        return self._probes[key]

    def res_jac(self, u, tc, pvec=None):
        """(residual (n_dof,), Jacobian rows: list of 144 entries, each
        None, a 0-d tensor or an (E,) tensor)."""
        asm = self.asm
        params = dict(asm.params)
        params.update({k: float(v) for k, v in (pvec or {}).items()})
        steady = self._is_steady(tc)
        alpha_u = 1.0 if steady else float(tc.alpha_u)
        alpha_t = 0.0 if steady else float(tc.alpha_t)
        form = self._form(tc)
        coeffs = self._coefficients(tc.time, params)
        jac_idx, consts, n_res = self._classify(coeffs, form, alpha_u,
                                                alpha_t, steady)
        self.stats = {"steady": steady, "split": False, "n_res_rows": n_res,
                      "n_jac_rows": len(jac_idx), "node_scatter": True}
        if steady:
            ue, ud, stage = self._grids(u), None, None
        else:
            ue = self._grids(alpha_u * u + tc.beta_u)
            ud = self._grids(alpha_t * u + tc.beta_t)
            stage = Stage(alpha_u, alpha_t, None)
        node, jac = ns_node_full(ue.contiguous(), ud if ud is None
                                 else ud.contiguous(), coeffs, self.tables,
                                 form, jac_idx, stage)
        r = torch.zeros(asm.n_dof, dtype=u.dtype, device=u.device)
        r[self.start:self.start + node.numel()] = node.reshape(-1)
        rows = self._rows(jac_idx, consts, jac)
        return torch.where(asm.fixed, 0.0, r), rows

    def _rows(self, jac_idx, consts, jac):
        """The 144 row entries: the kernel's varying rows, the probe's
        constants (one host-to-device copy) and None."""
        asm = self.asm
        cvals = [c for c in consts if c is not None]
        ct = iter(torch.tensor(cvals, dtype=asm.dtype, device=asm.device)
                  .unbind(0)) if cvals else iter(())
        pos = {k: i for i, k in enumerate(jac_idx)}
        rows = []
        for k in range(ND * ND):
            if k in pos:
                rows.append(jac[pos[k]])
            elif consts[k] is None:
                rows.append(None)
            else:
                rows.append(next(ct))
        return rows

    def jacobian(self, u, tc, pvec=None):
        """(residual, BlockJacobian) with the kernel's SoA row layout."""
        r, rows = self.res_jac(u, tc, pvec)
        return r, BlockJacobian(vol=None, vol_lids=self.asm.lids,
                                fixed=self.asm.fixed, inc=self.asm.inc,
                                vol_soa=rows)
