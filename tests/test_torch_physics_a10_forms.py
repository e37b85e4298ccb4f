"""The element and side residuals and Jacobians of A10's physics in
mrhyde_tpu_torch against the JAX package on the CPU in f64, at seeded
states and at the decks' initial states (zero velocity and momentum
where a deck starts from rest: the kinks of VDNS's and Burgers' |u| and
of cns's eigenvalues), steady and at a stage, within 1e-12 relative to
the largest entry; the decks of tests/test_torch_physics_a10.py."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (a10_decks, both_problems,  # noqa: E402
                              seeded, steady_coeffs)

torch.set_num_threads(1)

DECKS = a10_decks()


def _state(pj, kind, seed):
    """A seeded state about the deck's initial state (positive densities,
    depths and temperatures stay positive): "seeded" adds 0.05 x N(0, 1)
    per dof to it; "initial" is the initial state itself (zero velocity
    and momentum where the deck starts from rest)."""
    u0 = np.asarray(pj.initial_state())
    if kind == "initial":
        return u0
    return u0 + seeded(pj.n_dof, seed=seed, scale=0.05)


def _stage_coeffs(pj, pt, u, seed, alpha_u=0.5, alpha_t=40.0):
    """(JAX, torch) TimeCoeffs of a DIRK-2,2 stage 1 at dt = 0.05 about
    the state u: beta_u = (1 - alpha_u) u, beta_t = -alpha_t u, each
    plus 0.01 x N(0, 1) per dof, so that the stage's u_eval stays near u
    (a density or a depth stays positive) and its u_dot is O(1)."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    bu = (1.0 - alpha_u) * u + seeded(pj.n_dof, seed=seed, scale=0.01)
    bt = -alpha_t * u + seeded(pj.n_dof, seed=seed + 1, scale=0.01)
    tj = JaxTC(jnp.asarray(alpha_u), jnp.asarray(bu), jnp.asarray(alpha_t),
               jnp.asarray(bt), jnp.asarray(0.3), jnp.asarray(0.05))
    return tj, time_coeffs_from_numpy(alpha_u, bu, alpha_t, bt, 0.3, 0.05,
                                      pt)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    scale = max(float(np.max(np.abs(b))), 1e-300)
    return float(np.max(np.abs(a - b))) / scale


@pytest.mark.parametrize("name", sorted(DECKS))
def test_residual_and_jacobian_match_jax(name):
    """The assembled residual and the element and side Jacobian blocks at
    a seeded state and at the initial state (at rest where the deck
    starts from rest), each steady and at a DIRK-2,2 stage-1 stage about
    it, within 1e-12 of JAX's (all finite)."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(DECKS[name]())
    for state in ("seeded", "initial"):
        u = _state(pj, state, seed=11)
        for tj, tt in (steady_coeffs(pj, pt),
                       _stage_coeffs(pj, pt, u, seed=7)):
            rj = pj.assembler.residual(jnp.asarray(u), tj)
            rt = pt.assembler.residual(state_from_numpy(u, pt), tt)
            assert np.all(np.isfinite(rt.numpy()))
            assert _rel(rt.numpy(), rj) <= 1e-12, state
            Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
            Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
            assert np.all(np.isfinite(Jt.vol.numpy()))
            assert _rel(Jt.vol.numpy(), Jj.vol) <= 1e-12, state
            assert len(Jt.bnd) == len(Jj.bnd)
            for bt, bj in zip(Jt.bnd, Jj.bnd):
                assert np.all(np.isfinite(bt.numpy()))
                assert _rel(bt.numpy(), bj) <= 1e-12, state


def test_cns_far_field_side_jacobian_reads_the_eigenvectors():
    """cns's Far-field sides assemble a Jacobian block per side that
    differs from the slip deck's (the per-qp inverse of the eigenvector
    matrix under vmap(jacfwd)), and each matches JAX's."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    blocks = {}
    for bc in ("Slip", "Far-field"):
        pj, pt = both_problems(cs.cns_deck(4, bc=bc))
        tj, tt = steady_coeffs(pj, pt)
        u = _state(pj, "seeded", seed=5)
        Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
        Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
        assert len(Jt.bnd) == 4
        for bt, bj in zip(Jt.bnd, Jj.bnd):
            assert _rel(bt.numpy(), bj) <= 1e-12
        blocks[bc] = Jt.bnd[0].numpy()
    assert np.max(np.abs(blocks["Far-field"] - blocks["Slip"])) > 1e-3


def test_msphasefield_legacy_reads_the_last_quadrature_point():
    """With the legacy first-qp sampling the residual reads each
    element's fields at its last quadrature point only: at a state whose
    qps differ it differs from the consistent form's, and JAX's equals
    the port's; 'legacy qp index: 0' reads the first point instead."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    res = {}
    for key, legacy, qi in (("on", True, None), ("off", False, None),
                            ("first", True, 0)):
        cfg = cs.phasefield_deck(4, legacy=legacy)
        if qi is not None:
            cfg["Physics"]["legacy qp index"] = qi
        pj, pt = both_problems(cfg)
        tj, tt = steady_coeffs(pj, pt)
        u = seeded(pj.n_dof, seed=2)
        rj = np.asarray(pj.assembler.residual(jnp.asarray(u), tj))
        rt = pt.assembler.residual(state_from_numpy(u, pt), tt).numpy()
        assert _rel(rt, rj) <= 1e-12
        res[key] = rt
    assert np.max(np.abs(res["on"] - res["off"])) > 1e-3
    assert np.max(np.abs(res["on"] - res["first"])) > 1e-3


def test_abs_has_jax_s_tangent_at_zero():
    """jnp.abs's tangent at 0 is +1 (torch.abs's is 0): the modules'
    abs_ (Burgers' entropy residual, cns's eigenvalues u.n at rest) and
    the DSL's abs follow JAX's, on both sides of the kink too."""
    import jax.numpy as jnp
    from mrhyde_tpu.functions.parser import parse_expression as jax_parse
    from mrhyde_tpu_torch.functions.parser import parse_expression
    from mrhyde_tpu_torch.ops.sparse_dual import abs_
    x = np.array([-0.5, -0.0, 0.0, 0.25])
    want = np.asarray(jax.vmap(jax.jacfwd(jnp.abs))(jnp.asarray(x)))
    t = torch.tensor(x)
    got = torch.func.vmap(torch.func.jacfwd(abs_))(t).numpy()
    np.testing.assert_array_equal(got, want)
    expr_t = parse_expression("abs(a)")
    expr_j = jax_parse("abs(a)")
    got = torch.func.vmap(torch.func.jacfwd(
        lambda a: expr_t.evaluate({"a": a}.__getitem__)))(t).numpy()
    want = np.asarray(jax.vmap(jax.jacfwd(
        lambda a: expr_j.evaluate({"a": a}.__getitem__)))(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(want, [-1.0, 1.0, 1.0, 1.0])
