"""Element-tile assembly of the scalar advection-diffusion-reaction weak
form (thermal, with or without advection, and cdr) on uniform 3D hex
(p1) and 2D p2 quads.

The port of the JAX package's element-tile TPU kernel B1 (`run_call` in
mrhyde_tpu/ops/fused_p1.py, body `FusedP1Assembly._kernel(node=False)`)
for that weak form, in its two launched modes. Unlike the
node-scatter kernel B2 (ops/fused_p1.py, 2D p1), B1 writes per-element
rows; the caller scatters them to the nodes (pad+sum on the p1 node
grid, strided adds on the p2 fine lattice), as the JAX package does
outside its kernel.

- `thermal_elem_state` (mode "state", the affine split): the (nc, E)
  residual rows of the state part, sum_q w kappa grad phi_c . grad u_h
  (steady) or sum_q w [m alpha_t u_h phi_c + kappa alpha_u grad phi_c .
  grad u_h] (a transient Stage), from the variable's grid; with a
  velocity b, phi_c alpha_u b . grad u_h joins the sum.
- `thermal_elem_full` (mode "full"): the (nc, E) residual rows and the
  (nc*nc, E) Jacobian rows at the u_eval grid, fed the per-qp (E, Q)
  tensors S, dS/de, kappa, dkappa/de (and m in a stage) of the torch
  pre-pass; with a velocity, S gains b . grad u_eval and column c' gains
  alpha_u phi_c b . grad phi_c' (the one term that makes the Jacobian
  nonsymmetric).

The entry names keep `thermal_`: thermal and cdr share the weak form,
cdr with m = 1 and kappa = diffusion / (rho cp). A velocity is None (no
advection) or `dim` components, each a Python float or an (E, Q)
tensor.

A variable's grid is its p1 node grid (N0+1, N1+1, N2+1) or its p2 fine
lattice (2 N0+1, 2 N1+1); a `Lattice` says where local dof c of element
(I, J[, K]) sits on it: grid point stride * (I, J[, K]) + offsets[c].
Element e is C-order over the element grid, local dofs in dofmap order,
Jacobian row k = c * nc + c'. Both kernels are hand-written CUDA
(csrc/fused_elem_thermal.cu); each wrapper takes its plain-torch version
on CPU tensors only, and on CUDA tensors launches or raises. Launches
count in _launch.LAUNCHES ("elem_state", "elem_full").
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from mrhyde_tpu_torch.ops._launch import (LAUNCHES, check_err, check_qp,
                                          coeff_args, stage_args, stream,
                                          velocity_args)

__all__ = ["Lattice", "thermal_elem_state", "thermal_elem_full",
           "thermal_elem_state_plain", "thermal_elem_full_plain",
           "basis_lattice", "elem_dims", "corner_values", "scatter_rows",
           "fine_lattice_maps", "structured_lattice", "scatter_dofs"]

# (dim, nc) pairs the CUDA kernels are instantiated for: hex p1, quad p2
KERNEL_CASES = ((3, 8), (2, 9))


class Lattice(NamedTuple):
    """Local dof c of element (I, J[, K]) is grid point stride * (I, J[,
    K]) + offsets[c]: stride 1 on a p1 node grid, 2 on a p2 fine
    lattice."""
    offsets: tuple
    stride: int


def basis_lattice(cell, order):
    """The Lattice of the nodal HGRAD basis of this order on this cell:
    its dof coordinates on [-1, 1]^dim scaled to {0, .., order}, in
    dofmap order (the JAX package's `corners` for p > 1)."""
    import numpy as np
    from mrhyde_tpu_torch.fem.basis import get_basis
    pts = np.asarray(get_basis(cell, "HGRAD", order).dof_coords)
    lat = np.rint((pts + 1.0) / 2.0 * order).astype(int)
    return Lattice(tuple(tuple(int(x) for x in r) for r in lat), order)


def elem_dims(grid, lat):
    """The element grid (N0, N1[, N2]) of a variable's grid."""
    return tuple((g - 1) // lat.stride for g in grid.shape)


def corner_values(grid, lat):
    """[local dof c's value in every element, (E,)] for c in dofmap
    order: strided views of the grid."""
    dims = elem_dims(grid, lat)
    p = lat.stride
    return [grid[tuple(slice(o, o + p * (n - 1) + 1, p)
                       for o, n in zip(off, dims))].reshape(-1)
            for off in lat.offsets]


def scatter_rows(rows, lat, dims, like):
    """Per-element rows, one per local dof (each an (E,) or (*dims)
    tensor, or a scalar), summed to the variable's grid (stride * dims +
    1): one strided add per local dof, in order. Each grid point sums
    its elements' rows in the order of the JAX package's pad+sum."""
    p = lat.stride
    grid = like.new_zeros(tuple(p * n + 1 for n in dims))
    for row, off in zip(rows, lat.offsets):
        if isinstance(row, torch.Tensor) and row.dim() > 0:
            row = row.reshape(dims)
        grid[tuple(slice(o, o + p * (n - 1) + 1, p)
                   for o, n in zip(off, dims))] += row
    return grid


def fine_lattice_maps(lids, dims, lat, starts):
    """The p2 fine lattices (stride dims + 1 points per axis) of the
    variables whose dofs start at `starts`, as the JAX package's
    `_build_fine_maps`: fine[vi] holds the global dof of each lattice
    point (local dof c of element (I, J) sits at stride (I, J) +
    offsets[c] and is column vi nc + c of the element's lids), d2f[vi]
    the lattice point of each of variable vi's dofs. Returns (fine
    (n_var, *lattice) int64 array, [d2f per variable])."""
    import numpy as np
    p, nc = lat.stride, len(lat.offsets)
    fshape = tuple(p * n + 1 for n in dims)
    lids = np.asarray(lids)
    idx = np.meshgrid(*[np.arange(n) for n in dims], indexing="ij")
    fines, d2fs = [], []
    for vi, st in enumerate(starts):
        fine = np.full(fshape, -1, dtype=np.int64)
        for c, off in enumerate(lat.offsets):
            fine[tuple(p * i + o for i, o in zip(idx, off))] = \
                lids[:, vi * nc + c].reshape(dims)
        nvd = fine.size
        if not np.array_equal(np.sort(fine.ravel()),
                              np.arange(st, st + nvd)):
            raise AssertionError("the p2 fine lattice does not cover the "
                                 "variable's dofs once each")
        d2f = np.empty(nvd, dtype=np.int64)
        d2f[fine.ravel() - st] = np.arange(nvd)
        fines.append(fine)
        d2fs.append(d2f)
    return np.stack(fines), d2fs


def _at_q(v, q):
    """Quadrature point q of a per-qp (E, Q) tensor, or a scalar."""
    return v[:, q] if isinstance(v, torch.Tensor) else v


def _qp_state(tab, uc, q, values):
    """(u_h or None, [d u_h / d x_d]) at quadrature point q, (E,)."""
    nc = len(uc)
    g = [sum(tab.grad[c][q][d] * uc[c] for c in range(nc))
         for d in range(tab.dim)]
    uh = sum(tab.phi[c][q] * uc[c] for c in range(nc)) if values else None
    return uh, g


# ----------------------------------------------------------------------
# plain versions: the JAX package's `_accumulate` for the thermal weak
# form, corners and quadrature points in its order (fused_p1.py:357-495)
# ----------------------------------------------------------------------

def _advection(vel, q, g):
    """b . g at quadrature point q, (E,)."""
    return sum(_at_q(b, q) * gd for b, gd in zip(vel, g))


def thermal_elem_state_plain(grid, kappa, tab, lat, stage=None, vel=None):
    """(nc, E) residual rows of the state part at the grid's values.
    kappa, stage.mass, each velocity component: Python float or an (E,
    Q) tensor."""
    uc = corner_values(grid, lat)
    nc = len(uc)
    rows = [None] * nc
    for q in range(tab.Q):
        uh, g = _qp_state(tab, uc, q, stage is not None)
        k = _at_q(kappa, q)
        s = None
        if stage is None:
            flux = [k * gd for gd in g]
        else:
            g = [stage.alpha_u * gd for gd in g]
            flux = [k * gd for gd in g]
            s = _at_q(stage.mass, q) * (stage.alpha_t * uh)
        if vel is not None:
            adv = _advection(vel, q, g)
            s = adv if s is None else s + adv
        for c in range(nc):
            a = sum(tab.grad[c][q][d] * flux[d] for d in range(tab.dim))
            if s is not None:
                a = tab.phi[c][q] * s + a
            a = tab.wts[q] * a
            rows[c] = a if rows[c] is None else rows[c] + a
    return torch.stack(rows)


def thermal_elem_full_plain(grid, S, dS, K, dK, tab, lat, stage=None,
                            vel=None):
    """((nc, E) residual rows, (nc*nc, E) Jacobian rows) of the full weak
    form at the u_eval grid, from the per-qp (E, Q) tensors S, dS/de,
    kappa, dkappa/de. With a Stage the columns carry alpha_u on the
    u_eval tangents and alpha_t m on the u_dot one; with a velocity S
    gains b . grad u_eval and column c' b . grad phi_c'."""
    uc = corner_values(grid, lat)
    nc, dim = len(uc), tab.dim
    rows = [None] * nc
    jac = [None] * (nc * nc)
    for q in range(tab.Q):
        _uh, g = _qp_state(tab, uc, q, False)
        sq, kq, dkq, dsq = (S[:, q], K[:, q], dK[:, q], dS[:, q])
        if vel is not None:
            sq = sq + _advection(vel, q, g)
        w = tab.wts[q]
        flux = [kq * gd for gd in g]
        for c in range(nc):
            a = tab.phi[c][q] * sq + sum(tab.grad[c][q][d] * flux[d]
                                         for d in range(dim))
            rows[c] = w * a if rows[c] is None else rows[c] + w * a
        for cp in range(nc):
            pcp = tab.phi[cp][q]
            ts = pcp * dsq
            if vel is not None:
                ts = ts + _advection(vel, q, tab.grad[cp][q])
            tf = [pcp * (dkq * g[d]) + tab.grad[cp][q][d] * kq
                  for d in range(dim)]
            if stage is not None:
                ts = stage.alpha_u * ts + stage.alpha_t * (
                    pcp * _at_q(stage.mass, q))
                tf = [stage.alpha_u * t for t in tf]
            for c in range(nc):
                a = tab.phi[c][q] * ts + sum(tab.grad[c][q][d] * tf[d]
                                             for d in range(dim))
                k = c * nc + cp
                jac[k] = w * a if jac[k] is None else jac[k] + w * a
    return torch.stack(rows), torch.stack(jac)


def structured_lattice(asm, dims, starts):
    """(Lattice, grid shape, fine_idx, dof2fine) of a uniform structured
    problem whose variables start at `starts`: a p1 plan reads each
    variable's node grid (fine_idx and dof2fine None), a p2 plan its fine
    lattice through one gather (fine_idx (n_var, *lattice) the global
    dofs, dof2fine the lattice point of each variable's dofs; device
    tensors)."""
    s = asm._structured
    if s["plan"][0][0] == "p1":
        return (Lattice(tuple(tuple(c) for c in s["corners"]), 1),
                tuple(d + 1 for d in dims), None, None)
    lat = basis_lattice(asm.disc.mesh.cell_type, 2)
    fine, d2f = fine_lattice_maps(asm.disc.lids, dims, lat, starts)
    return (lat, fine.shape[1:], torch.as_tensor(fine, device=asm.device),
            [torch.as_tensor(d, device=asm.device) for d in d2f])


def scatter_dofs(res, r, starts, lat, dims, like, dof2fine=None):
    """Adds the (n_var nc, E) residual rows of an element kernel, summed
    to each variable's grid (and on a p2 fine lattice through dof2fine
    to its dofs), into the dof vector r at each variable's start."""
    nc = len(lat.offsets)
    for vi, st in enumerate(starts):
        grid = scatter_rows(res[vi * nc:(vi + 1) * nc], lat, dims,
                            like).reshape(-1)
        if dof2fine is not None:
            grid = grid[dof2fine[vi]]
        r[st:st + grid.numel()] = grid


# ----------------------------------------------------------------------
# kernel wrappers
# ----------------------------------------------------------------------

def _check_grid(grid, tab, lat):
    if grid.device.type != "cuda":
        raise ValueError(f"element kernels take cpu or cuda tensors, not "
                         f"{grid.device}")
    if grid.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"element kernels take f32/f64, not {grid.dtype}")
    nc = len(lat.offsets)
    if (tab.dim, nc) not in KERNEL_CASES or tab.nc != nc \
            or grid.dim() != tab.dim:
        raise ValueError(f"element kernels take (dim, nc) in "
                         f"{KERNEL_CASES} with matching tables, not a "
                         f"{grid.dim()}-d grid with {nc} local dofs and "
                         f"({tab.dim}, {tab.nc}) tables")
    p = lat.stride
    if not grid.is_contiguous() or any(
            g < p + 1 or (g - 1) % p for g in grid.shape):
        raise ValueError(f"the grid must be contiguous with every axis "
                         f"{lat.stride} * N + 1, N >= 1; got "
                         f"{tuple(grid.shape)}")
    if grid.numel() > 2 ** 31 - 1:
        raise ValueError("grid too large for int indexing")
    tab.ptrs(grid)  # the tables' device and type (checked once)


# each lattice's offsets as the host int array the C entry points take,
# checked and built once per lattice
_LATTICE = {}


def _lattice_array(lat):
    arr = _LATTICE.get(lat)
    if arr is None:
        p = lat.stride
        if any(not 0 <= o <= p for off in lat.offsets for o in off):
            raise ValueError(f"lattice offsets must lie in [0, {p}]")
        flat = [int(o) for off in lat.offsets for o in off]
        arr = _LATTICE[lat] = (ctypes.c_int * len(flat))(*flat)
    return arr


def _geometry_args(grid, tab, lat):
    """phi, grad, wts, Q, nc, dim, lattice (host int array), stride, N0,
    N1, N2 (N2 = 1 in 2D) for the C entry points; raises where the tables
    live on another device or type than the grid (checked once per
    QuadTables)."""
    dims = list(elem_dims(grid, lat)) + [1] * (3 - tab.dim)
    return (*tab.ptrs(grid), tab.Q, len(lat.offsets), tab.dim,
            _lattice_array(lat), lat.stride, *dims)


# the element kernels' C entry points per (name, dtype), bound at their
# first call
_ENTRY = {}


def _entry(name, dtype):
    fn = _ENTRY.get((name, dtype))
    if fn is None:
        from mrhyde_tpu_torch.ops._build import load_library
        fn = _ENTRY[name, dtype] = getattr(
            load_library(),
            f"{name}_{'f64' if dtype == torch.float64 else 'f32'}")
    return fn


def thermal_elem_state(grid, kappa, tab, lat, stage=None, vel=None):
    """The (nc, E) state-part residual rows: the CUDA kernel on a CUDA
    grid, the plain version on a CPU grid. kappa: Python float or (E,
    Q); stage: None (steady) or a Stage; vel: None or the velocity."""
    if grid.device.type == "cpu":
        return thermal_elem_state_plain(grid, kappa, tab, lat, stage, vel)
    _check_grid(grid, tab, lat)
    geo = _geometry_args(grid, tab, lat)
    E = math.prod(geo[-3:])
    kap = coeff_args(kappa, E, grid, tab, "kappa")
    st = stage_args(stage, E, grid, tab)
    va = velocity_args(vel, E, grid, tab)
    rows = torch.empty((len(lat.offsets), E), dtype=grid.dtype,
                       device=grid.device)
    check_err("thermal_elem_state",
              _entry("thermal_elem_state", grid.dtype)(
                  grid.data_ptr(), *kap, *st, *va, *geo, rows.data_ptr(),
                  stream(grid)), tab.Q)
    LAUNCHES["elem_state"] += 1
    return rows


def thermal_elem_full(grid, S, dS, K, dK, tab, lat, stage=None, vel=None):
    """((nc, E) residual rows, (nc*nc, E) Jacobian rows) at the u_eval
    grid: the CUDA kernel on CUDA tensors, the plain version on CPU
    tensors. stage: None (steady) or a Stage; vel: None or the
    velocity."""
    if grid.device.type == "cpu":
        return thermal_elem_full_plain(grid, S, dS, K, dK, tab, lat, stage,
                                       vel)
    _check_grid(grid, tab, lat)
    geo = _geometry_args(grid, tab, lat)
    E = math.prod(geo[-3:])
    for name, t in (("S", S), ("dS", dS), ("K", K), ("dK", dK)):
        check_qp(t, E, grid, tab, name)
    st = stage_args(stage, E, grid, tab)
    va = velocity_args(vel, E, grid, tab)
    nc = len(lat.offsets)
    rows = torch.empty((nc, E), dtype=grid.dtype, device=grid.device)
    jac = torch.empty((nc * nc, E), dtype=grid.dtype, device=grid.device)
    check_err("thermal_elem_full",
              _entry("thermal_elem_full", grid.dtype)(
                  grid.data_ptr(), S.data_ptr(), dS.data_ptr(),
                  K.data_ptr(), dK.data_ptr(), *st, *va, *geo,
                  rows.data_ptr(), jac.data_ptr(), stream(grid)), tab.Q)
    LAUNCHES["elem_full"] += 1
    return rows, jac
