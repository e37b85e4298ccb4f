"""The element and side residuals and Jacobians of A11's physics in
mrhyde_tpu_torch against the JAX package on the CPU in f64, at a seeded
state about each deck's initial state, steady and at a stage, within
1e-12 relative to the largest entry: the oriented (W^T J W) volume
blocks, the face terms inside the element residual (hybridized and weak
Galerkin porous flow, Euler's HDG form with its order-1 traces) and the
side blocks of the boundary operators (natural pressure data, Far-field
and Slip); the decks of tests/test_torch_physics_a11.py, plus the
hybridized form on hex with an order-1 trace."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (a11_decks, both_problems,  # noqa: E402
                              seeded, steady_coeffs)

torch.set_num_threads(1)


def _hybrid_hex_order1():
    cfg = a11_decks()["hybrid_hex"]()
    cfg["Discretization"]["order"]["lambda"] = 1
    return cfg


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


def _stage_coeffs(pj, pt, u, seed, alpha_u=0.5, alpha_t=40.0):
    """(JAX, torch) TimeCoeffs of a DIRK-2,2 stage 1 at dt = 0.05 about
    u: beta_u = (1 - alpha_u) u, beta_t = -alpha_t u, each plus 0.01 x
    N(0, 1) per dof (densities and depths stay positive)."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    bu = (1.0 - alpha_u) * u + seeded(pj.n_dof, seed=seed, scale=0.01)
    bt = -alpha_t * u + seeded(pj.n_dof, seed=seed + 1, scale=0.01)
    tj = JaxTC(jnp.asarray(alpha_u), jnp.asarray(bu), jnp.asarray(alpha_t),
               jnp.asarray(bt), jnp.asarray(0.3), jnp.asarray(0.05))
    return tj, time_coeffs_from_numpy(alpha_u, bu, alpha_t, bt, 0.3, 0.05,
                                      pt)


def _decks(tmp):
    decks = a11_decks(tmp)
    decks["hybrid_hex_trace_order1"] = _hybrid_hex_order1
    return decks


NAMES = sorted(_decks("unused"))


@pytest.mark.parametrize("name", NAMES)
def test_residual_and_jacobian_match_jax(name, tmp_path):
    """The assembled residual, the folded element Jacobian blocks and the
    boundary groups' blocks at the initial state plus 0.05 x N(0, 1) per
    dof, within 1e-12 of JAX's (all finite): steady for a steady deck,
    at a DIRK-2,2 stage-1 stage about that state for a transient one
    (its time-derivative terms live)."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(_decks(str(tmp_path))[name]())
    u = np.asarray(pj.initial_state()) + seeded(pj.n_dof, seed=11,
                                                scale=0.05)
    transient = pt.solver_cfg.get("solver") == "transient"
    tj, tt = _stage_coeffs(pj, pt, u, seed=7) if transient \
        else steady_coeffs(pj, pt)
    rj = pj.assembler.residual_jit(jnp.asarray(u), tj)
    rt = pt.assembler.residual(state_from_numpy(u, pt), tt)
    assert np.all(np.isfinite(rt.numpy()))
    assert _rel(rt.numpy(), rj) <= 1e-12
    Jj = pj.assembler.jacobian_jit(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    assert np.all(np.isfinite(Jt.vol.numpy()))
    assert _rel(Jt.vol.numpy(), Jj.vol) <= 1e-12
    assert len(Jt.bnd) == len(Jj.bnd)
    for bt, bj in zip(Jt.bnd, Jj.bnd):
        assert _rel(bt.numpy(), bj) <= 1e-12
