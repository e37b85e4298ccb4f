"""Hand state across between the JAX package and this port.

Both packages build their DOF maps from identical copies of the host
modules, so `lids`, `fixed`, `var_start` and the node-grid order agree
index by index: a solution vector crosses as a plain numpy array. So do
the analyses' inputs: a discretized parameter's field (a DOF vector of
its own map, or (n_steps, n_dof) when dynamic), an optimizer's flat
parameter vector, and a UQ sample.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["state_from_numpy", "state_to_numpy", "params_from_numpy",
           "time_coeffs_from_numpy", "field_from_numpy", "pvec_from_flat",
           "sample_from_numpy"]


def state_from_numpy(u, problem):
    """numpy (n_dof,) -> tensor on `problem.device` in `problem.dtype`."""
    u = np.asarray(u)
    if u.shape != (problem.n_dof,):
        raise ValueError(f"state of shape {u.shape}, expected "
                         f"({problem.n_dof},)")
    return torch.tensor(u, dtype=problem.dtype, device=problem.device)


def time_coeffs_from_numpy(alpha_u, beta_u, alpha_t, beta_t, time, deltat,
                           problem):
    """One stage's TimeCoeffs from numpy: the betas as (n_dof,) states on
    `problem.device` in `problem.dtype`, the scalars as floats."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    return TimeCoeffs(float(alpha_u), state_from_numpy(beta_u, problem),
                      float(alpha_t), state_from_numpy(beta_t, problem),
                      float(time), float(deltat))


def state_to_numpy(u):
    """Tensor -> float numpy array on the host."""
    return u.detach().cpu().numpy()


def params_from_numpy(params, device="cpu", dtype=torch.float64):
    """{name: scalar} -> {name: 0-d tensor} (scalar Parameters only)."""
    out = {}
    for k, v in params.items():
        a = np.asarray(v)
        if a.ndim != 0:
            raise ValueError(f"parameter {k!r} is not a scalar")
        out[k] = torch.as_tensor(float(a), dtype=dtype, device=device)
    return out


def field_from_numpy(values, problem, name):
    """The discretized parameter `name`'s field from numpy: a (n_dof,)
    vector of its own DOF map, or (n_steps, n_dof) for a dynamic one,
    as a tensor on `problem.device` in `problem.dtype`."""
    spec = problem.param_manager.specs[name]
    n = problem.assembler.field_params[name]["n_dof"]
    v = np.asarray(values, dtype=float)
    want = (v.shape[0], n) if spec.dynamic and v.ndim == 2 else (n,)
    if v.shape != want:
        raise ValueError(f"field {name!r} of shape {v.shape}, expected "
                         f"{want}")
    return torch.tensor(v, dtype=problem.dtype, device=problem.device)


def pvec_from_flat(x, problem):
    """An optimizer's flat parameter vector (numpy, the active
    parameters in declaration order) -> pvec: 0-d tensors for scalars,
    1-d for vectors and fields, (n_steps, n_dof) for dynamic fields."""
    vec = torch.as_tensor(np.asarray(x, dtype=float), dtype=problem.dtype,
                          device=problem.device)
    return problem.param_manager.unflatten(vec)


def sample_from_numpy(sample, problem):
    """One UQ sample {name: scalar or (k,) array} -> pvec tensors."""
    return {k: torch.as_tensor(np.asarray(v, dtype=float),
                               dtype=problem.dtype, device=problem.device)
            for k, v in sample.items()}
