"""Launch helpers shared by the kernel wrappers of ops/fused_p1.py,
ops/fused_ns.py, ops/fused_elem.py and ops/fused_set.py: the launch counts, the pointer and
stream arguments, the scalar-or-(E, Q) coefficient, stage and
velocity arguments of the C entry points (ops/_build.py), the argument
struct and tile list of the element-tile engine (csrc/elem_engine.cuh:
`ns_elem_full`, `set_elem_*`), and the shared-memory layouts of the
element-tile kernels, of `set_node_full`'s Jacobian blocks, of the state
kernels `set_node_state` and `set_elem_state` and of the node kernels
`thermal_node_state`, `thermal_node_full` and `ns_node_full`."""

from __future__ import annotations

import ctypes

import numpy as np
import torch

__all__ = ["LAUNCHES", "ptr", "stream", "check_qp", "coeff_args",
           "stage_args", "velocity_args", "SMEM_OPTIN", "elem_smem_words",
           "node_smem_words", "set_state_smem_words",
           "elem_state_smem_words", "state_smem_words", "full_smem_words",
           "ns_node_smem_words",
           "block_elems", "check_smem", "check_err",
           "ElemArgs", "ELEM_MAX_SCALARS", "elem_tiles"]

# kernel launches per kernel: thermal "state" and "full" (B2,
# ops/fused_p1.py), the Navier-Stokes "full" kernels (B2 "ns_full" and B1
# "ns_elem_full", ops/fused_ns.py), the thermal element kernels (B1,
# ops/fused_elem.py) and the generated module-set kernels (B2
# "set_node_full", "set_node_state" and B1 "set_elem_full",
# "set_elem_state", ops/fused_set.py); each wrapper adds one where it
# launches; reset by whoever wants to count a run
LAUNCHES = {"state": 0, "full": 0, "ns_full": 0, "elem_state": 0,
            "elem_full": 0, "ns_elem_full": 0, "set_node_full": 0,
            "set_elem_full": 0, "set_node_state": 0, "set_elem_state": 0}

# the H100's shared memory per block with opt-in
# (cudaDevAttrMaxSharedMemoryPerBlockOptin, 227 KiB): the providers refuse
# a quadrature whose layout of one element exceeds it; the kernels read
# the card's own value at each launch
SMEM_OPTIN = 232448
# what the kernels' C entry points return where one element's layout
# exceeds the card's limit (kErrSharedMemory)
_ERR_SMEM = -1


# the element-tile engine's qps linearized in one chunk, at most, and per
# chunk where they take several (elem_engine.cuh kQc, kQcMulti), and the
# scalars its argument struct carries (kMaxScalars)
ELEM_QC = 9
ELEM_QC_MULTI = 5
ELEM_MAX_SCALARS = 32


def elem_smem_words(dim, nc, nv, transient, Q, elems):
    """Words of an element-tile block's shared memory in mode "full"
    (csrc/elem_engine.cuh `ElemLayout::total`): the tables, `elems`
    elements' qp state and corner coordinates, then the larger of what the
    residual phases hold (the corner values and primal densities) and what
    the Jacobian phase holds over them (a chunk of the linearization, and
    the tiles' sums between chunks where the qps take several)."""
    nd, no = nv * nc, nv * (1 + dim)
    nq = no + (nv if transient else 0)
    tables = nc * Q * (1 + dim) + Q
    residual = elems * (2 if transient else 1) * nd + elems * Q * no
    chunks = 1 if Q <= ELEM_QC else -(-Q // ELEM_QC_MULTI)
    jacobian = elems * (-(-Q // chunks) * (no * nq + 1) + 1) \
        + (elems * nd * nd if Q > ELEM_QC else 0)
    return tables + elems * (Q * nq + dim) + max(residual, jacobian)


def node_smem_words(nv, transient, Q, elems):
    """Words of a set_node_full Jacobian block's shared memory
    (csrc/set_node.cuh `SetLayout`): the engine's layout at nc = 4, or
    for one variable and past ELEM_QC qps the per-column one (the
    tables, the corner values, the qp state)."""
    if nv > 1 and Q <= ELEM_QC:
        return elem_smem_words(2, 4, nv, transient, Q, elems)
    nq = 3 * nv + (nv if transient else 0)
    return 13 * Q + elems * (2 if transient else 1) * 4 * nv \
        + elems * Q * nq


def set_state_smem_words(nv, Q):
    """Words of a set_node_state block's shared memory
    (csrc/set_node.cuh `set_state_words`): the tables, the weights and
    the qps' offsets in blocks of 16 per qp, and for each of the nv grids
    twice (a tile's and the next one's) the 17 x 33 node patch of a 16 x
    32 element tile and the four corner rows of its elements."""
    return 16 * Q + nv * 2 * (17 * 33 + 4 * 512)


def elem_state_smem_words(dim, nc, Q):
    """Words of a set_elem_state block's shared memory (csrc/set_elem.cuh
    `ElemStateQp::words`): per qp its nc values of phi, nc dim of grad,
    the weight and the dim offsets, padded to a multiple of 4."""
    return Q * (-(-(nc * (1 + dim) + 1 + dim) // 4) * 4)


def state_smem_words(Q):
    """Words of a thermal_node_state block's shared memory
    (csrc/fused_p1_thermal.cu `state_smem_words`): the tables (13 Q), and
    twice (a tile's and the next one's) the 17 x 33 node patch of a 16 x
    32 element tile and the four corner rows of its elements."""
    return 13 * Q + 2 * (17 * 33 + 4 * 512)


def full_smem_words(Q, advect):
    """Words of a thermal_node_full block's shared memory
    (csrc/fused_p1_thermal.cu `full_smem_words`): the tables (13 Q, padded
    to a multiple of 4), the weighted basis products of every qp (16
    entries of each of the 4 Jacobian kinds, 6 with advection, and 4 rows
    of each of the 3 residual kinds), and the state block's patches and
    rows."""
    per_q = (6 if advect else 4) * 16 + 3 * 4
    return -(-13 * Q // 4) * 4 + Q * per_q + 2 * (17 * 33 + 4 * 512)


def ns_node_smem_words(Q):
    """Words of an ns_node_full block's shared memory
    (csrc/fused_p1_ns.cu `ns_smem_words`): the 12 residual rows of the 8
    x 16 elements its tile owns, and the primal densities (9 per qp) of
    the 25 halo elements its nodes also touch."""
    return 128 * 12 + 25 * Q * 9


def block_elems(words, itemsize, limit=SMEM_OPTIN):
    """The elements per block the kernels take: the most of 16, 8, ...,
    1 whose layout (`words(elems)` words of `itemsize` bytes) fits
    `limit` bytes, or 0."""
    elems = 16
    while elems >= 1:
        if words(elems) * itemsize <= limit:
            return elems
        elems //= 2
    return 0


def check_smem(name, words, itemsize, Q):
    """Raises ValueError where the smallest block's layout of quadrature
    Q (one element's; `words(1)` words) exceeds the H100's shared memory
    per block."""
    if block_elems(words, itemsize) == 0:
        raise ValueError(
            f"{name} at {Q} quadrature points needs "
            f"{words(1) * itemsize} bytes of shared memory for its smallest "
            f"block, above the card's {SMEM_OPTIN} bytes per block: "
            "lower the deck's quadrature")


def check_err(name, err, Q=None):
    """Raises on a failed launch: a layout past the card's shared memory,
    or a CUDA error."""
    if err == _ERR_SMEM:
        raise RuntimeError(
            f"{name}: its block's layout at {Q} quadrature points does not "
            "fit the card's shared memory per block")
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(t):
    """The current CUDA stream of t's device, as the address the C entry
    points take."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def check_qp(t, E, grid, tab, name):
    """A per-qp input must be a contiguous (E, Q) tensor of the grid's
    device and type."""
    if not isinstance(t, torch.Tensor) or t.shape != (E, tab.Q) \
            or t.device != grid.device or t.dtype != grid.dtype \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous ({E}, {tab.Q}) "
                         f"{grid.dtype} tensor on {grid.device}")


def coeff_args(v, E, grid, tab, name):
    """A scalar-or-(E, Q) coefficient as the kernels take it: (pointer
    or None, scalar value, is_scalar)."""
    if not isinstance(v, torch.Tensor):
        return None, float(v), 1
    check_qp(v, E, grid, tab, name)
    return v.data_ptr(), 0.0, 0


def stage_args(stage, E, grid, tab):
    """(mass pointer, mass scalar, mass_is_scalar, alpha_u, alpha_t,
    transient) for the C entry points; steady is (None, 0, 1, 1, 0, 0)."""
    if stage is None:
        return (None, 0.0, 1, 1.0, 0.0, 0)
    return (*coeff_args(stage.mass, E, grid, tab, "mass"),
            float(stage.alpha_u), float(stage.alpha_t), 1)


def velocity_args(vel, E, grid, tab):
    """(advect, then pointer or None and scalar value of each of the
    three velocity components) for the C entry points: `vel` is None (no
    advection) or `dim` components, each a Python float or an (E, Q)
    tensor; the components past `dim` are unused zeros."""
    if vel is None:
        return (0,) + (None, 0.0) * 3
    if len(vel) != tab.dim:
        raise ValueError(f"the velocity needs {tab.dim} components, not "
                         f"{len(vel)}")
    out = [1]
    for d in range(3):
        if d < len(vel):
            p, s, _ = coeff_args(vel[d], E, grid, tab, f"velocity[{d}]")
            out += [p, s]
        else:
            out += [None, 0.0]
    return tuple(out)


class ElemArgs(ctypes.Structure):
    """The C side's ElemArgs (csrc/elem_engine.cuh), field for field: the
    arguments of every element-tile entry point (ns_elem_full_*,
    set_elem_full_*, set_elem_state_*)."""
    _fields_ = [("ue", ctypes.c_void_p), ("ud", ctypes.c_void_p),
                ("coef", ctypes.c_void_p * 5), ("coef0", ctypes.c_double * 5),
                ("phi", ctypes.c_void_p), ("grad", ctypes.c_void_p),
                ("wts", ctypes.c_void_p), ("row_pos", ctypes.c_void_p),
                ("tiles", ctypes.c_void_p),
                ("res", ctypes.c_void_p), ("jac", ctypes.c_void_p),
                ("alpha_u", ctypes.c_double), ("alpha_t", ctypes.c_double),
                ("h", ctypes.c_double), ("tau_dt2", ctypes.c_double),
                ("origin", ctypes.c_double * 3),
                ("hax", ctypes.c_double * 3),
                ("qoff", ctypes.c_void_p),
                ("sc", ctypes.c_double * ELEM_MAX_SCALARS),
                ("Q", ctypes.c_int), ("nc", ctypes.c_int),
                ("dim", ctypes.c_int), ("stride", ctypes.c_int),
                ("N0", ctypes.c_int), ("N1", ctypes.c_int),
                ("N2", ctypes.c_int), ("n_tiles", ctypes.c_int),
                ("pspg", ctypes.c_int),
                ("supg", ctypes.c_int), ("transient", ctypes.c_int),
                ("off", (ctypes.c_int * 3) * 9)]


_TILES = {}


def elem_tiles(jac_idx, nv, nc, device):
    """(n_tiles,) int32 device list of the tiles (v, w, g), coded (v nv +
    w) ng + g, that hold at least one element-varying row (row k = row nd
    + col, row = v nc + c, col = w nc + g S + j): the engine computes
    those alone."""
    key = (tuple(jac_idx), nv, nc, str(device))
    if key not in _TILES:
        # columns c' per tile (ElemLayout::S)
        nd, s = nv * nc, 4 if nc == 4 else (1 if nv == 1 else
                                            (4 if nc == 8 else 3))
        ng = nc // s
        codes = set()
        for k in jac_idx:
            row, col = divmod(int(k), nd)
            codes.add((row // nc * nv + col // nc) * ng + col % nc // s)
        _TILES[key] = torch.as_tensor(np.array(sorted(codes), dtype=np.int32),
                                      device=device)
    return _TILES[key]
