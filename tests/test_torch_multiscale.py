"""The multiscale subgrid method in mrhyde_tpu_torch (`multiscale/`,
steady) against the JAX package (`mrhyde_tpu/multiscale/`) on the CPU in
f64: the reference's DtN2 deck at 4x4 (refinements 1 and 2, the latter
also held to its golds), the upscaled residual and the macro Jacobian
blocks at a seeded macro state, a hex macro mesh, HFACE traces of order
0 and 1, a triangle macro mesh, the macro-element chunking and the CLI.
Every deck is built here (chip_smoke.py's deck functions at small
sizes); the porous and elasticity subgrids are in
test_torch_multiscale_physics.py."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import both_problems, seeded, solve_both  # noqa

torch.set_num_threads(1)

RTOL = 1e-10


@pytest.fixture(scope="module")
def dtn2_r1():
    """(JAX result, port result, port Problem) of the DtN2 deck at 4x4,
    refinements 1."""
    return solve_both(cs.multiscale_deck(4, 1), rtol=RTOL)


def test_dtn2_deck_refinements_1(dtn2_r1):
    _rj, rt, pt = dtn2_r1
    ms = pt.multiscale
    assert not ms.general and ms.n_fine_dof == 9
    assert pt.assembler.volume_off and pt.assembler.fused_provider() is None
    assert set(rt.errors) == {("L2-face", "e"), ("Subgrid-L2", "e")}


def test_dtn2_gold_deck_refinements_2():
    """thermal/2D_verification_multiscale: JAX's numbers at 1e-10 and the
    golds L2-face(e) 0.198706, Subgrid 0 L2(e) 0.042848 at 1e-3."""
    _rj, rt, _pt = solve_both(cs.multiscale_deck(4, 2), rtol=RTOL)
    assert np.isclose(rt.errors[("L2-face", "e")], 0.198706, rtol=1e-3)
    assert np.isclose(rt.errors[("Subgrid-L2", "e")], 0.042848, rtol=1e-3)


def test_contributions_at_a_seeded_state_match_jax():
    """residual_contribution, jacobian_contribution (d res / d u_stage,
    through the fixed-count fine Newton) and the fine solutions at a
    seeded macro state and a stage's alpha_u = 0.5: 1e-11."""
    import jax.numpy as jnp
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    pj, pt = both_problems(cs.multiscale_deck(4, 1))
    u = seeded(pj.n_dof, seed=7, scale=1.0)
    bu = seeded(pj.n_dof, seed=8)
    zero = np.zeros(pj.n_dof)
    tt = TimeCoeffs(0.5, torch.tensor(bu), 0.0, torch.tensor(zero), 0.0, 1.0)
    mj, mt = pj.multiscale, pt.multiscale
    ut = torch.tensor(u)

    def jax_call(f):
        # jitted: JAX's eager vmap of jacfwd takes ~20 s a call here
        return jax.jit(lambda u, bu: f(u, JTC(
            jnp.asarray(0.5), bu, jnp.asarray(0.0), jnp.asarray(zero),
            jnp.asarray(0.0), jnp.asarray(1.0))))(jnp.asarray(u),
                                                  jnp.asarray(bu))
    for a, b in ((jax_call(mj.residual_contribution),
                  mt.residual_contribution(ut, tt)),
                 (jax_call(mj.jacobian_contribution),
                  mt.jacobian_contribution(ut, tt)),
                 (jax_call(mj.fine_solutions), mt.fine_solutions(ut, tt))):
        a = np.asarray(a)
        assert b.shape == a.shape
        assert np.abs(b.numpy() - a).max() <= 1e-11 * np.abs(a).max()
    # the assembler's one pass equals the two separate contributions
    r, J = pt.assembler.res_and_jac(ut, tt)
    assert torch.equal(r, pt.assembler.residual(ut, tt))
    assert torch.allclose(J.dense(), pt.assembler.jacobian(ut, tt).dense(),
                          rtol=0, atol=1e-15)


def test_chunked_fine_solves_change_no_number(monkeypatch):
    """The macro elements split into chunks of 3 (a device with little
    free memory) give the same residual and blocks as one batch."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.multiscale import subgrid
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(cs.multiscale_deck(4, 1), device="cpu")
    ms = p.multiscale
    u = torch.tensor(seeded(p.n_dof, seed=3, scale=1.0))
    tc = TimeCoeffs.steady(p.n_dof)
    whole = ms.residual_and_blocks(u, tc)
    assert ms._chunk(True) == ms.n_macro_elems()
    per = 3 * ms.n_fine_dof ** 2 * (p.disc.ndof_elem + 1) \
        * subgrid._BYTES_PER_ENTRY * 8
    monkeypatch.setattr(subgrid, "free_bytes", lambda device: 4 * per)
    assert ms._chunk(True) == 3
    parts = ms.residual_and_blocks(u, tc)
    assert torch.allclose(parts[0], whole[0], rtol=0, atol=1e-15)
    assert torch.allclose(parts[1][0][0], whole[1][0][0], rtol=0, atol=1e-15)


DECKS = {
    "hex_nx3_r1": lambda: cs.multiscale_hex_deck(3, 1),
    "hface_order0": lambda: cs.multiscale_deck(4, 1, trace=0),
    "hface_order1": lambda: cs.multiscale_deck(4, 1, trace=1),
    "tri_nx4": lambda: cs.multiscale_deck(4, 0, cell="tri"),
}


@pytest.mark.parametrize("name", DECKS)
def test_subgrid_deck_matches_jax(name):
    """Every norm at 1e-10 and the macro solution: hex macro cells, HFACE
    macro traces of order 0 and 1, triangles (the general per-element
    geometry)."""
    _rj, rt, pt = solve_both(DECKS[name](), rtol=RTOL)
    assert pt.multiscale.general == (name == "tri_nx4")
    assert any(k[0] == "Subgrid-L2" for k in rt.errors)


def test_the_cli_prints_the_subgrid_lines(dtn2_r1, tmp_path, capsys):
    """`mrhyde_tpu_torch.driver deck.yaml --device cpu` on a deck with a
    Subgrid sublist prints the JAX package's report, the 'Subgrid 0:'
    line included."""
    import yaml

    from mrhyde_tpu_torch.driver import main
    rj, _rt, _pt = dtn2_r1
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(copy.deepcopy(cs.multiscale_deck(4, 1))))
    assert main([str(deck), "--device", "cpu"]) == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if "norm of the error" in ln]
    assert lines == [ln for ln in rj.report().splitlines()
                     if "norm of the error" in ln]
    assert any(ln.startswith("***** Subgrid 0: L2 norm") for ln in lines)
