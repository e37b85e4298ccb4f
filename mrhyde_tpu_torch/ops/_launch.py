"""Launch helpers shared by the kernel wrappers of ops/fused_p1.py,
ops/fused_ns.py, ops/fused_elem.py and ops/fused_set.py: the launch counts, the pointer and
stream arguments, and the scalar-or-(E, Q) coefficient, stage and
velocity arguments of the C entry points (ops/_build.py)."""

from __future__ import annotations

import ctypes

import torch

__all__ = ["LAUNCHES", "ptr", "stream", "check_qp", "coeff_args",
           "stage_args", "velocity_args"]

# kernel launches per kernel: thermal "state" and "full" (B2,
# ops/fused_p1.py), the Navier-Stokes "full" kernels (B2 "ns_full" and B1
# "ns_elem_full", ops/fused_ns.py), the thermal element kernels (B1,
# ops/fused_elem.py) and the generated module-set kernels (B2
# "set_node_full" and B1 "set_elem_full", ops/fused_set.py); each wrapper
# adds one where it launches; reset by whoever wants to count a run
LAUNCHES = {"state": 0, "full": 0, "ns_full": 0, "elem_state": 0,
            "elem_full": 0, "ns_elem_full": 0, "set_node_full": 0,
            "set_elem_full": 0}


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


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
    return ptr(v), 0.0, 0


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
