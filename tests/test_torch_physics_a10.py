"""The rest of A10's physics in mrhyde_tpu_torch (Burgers, Helmholtz,
Kuramoto-Sivashinsky, shallow water, msphasefield, phasesolidification,
VDNS, porous, shallow ice, Hartmann, llamas, inc sat with its wells,
physicsTest, cns on the Euler module's volume terms) against the JAX
package on the CPU in f64: each module's solution at every recorded time
within 1e-11 (relative to max |u|; every norm within 1e-11 of JAX's, or
1e-13 absolute for a norm that is 0 to round-off), and the reference's
golds of the decks that run in seconds
(tests/test_torch_physics_a10_forms.py holds the residuals and
Jacobians). None of these modules has a fused kernel in either package:
every deck takes the general path. The decks are chip_smoke.py's, at
small sizes."""

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (a10_decks, both_problems,  # noqa: E402
                              solve_both)

torch.set_num_threads(1)

DECKS = a10_decks()


@pytest.mark.parametrize("name", sorted(DECKS))
def test_solution_matches_jax(name):
    pt = solve_both(DECKS[name]())[2]
    assert pt.assembler.fused_provider() is None


@pytest.mark.parametrize("name,times", [
    # burgers/1D_Nonlinear_Backtracking (tests/test_cdr_burgers.py)
    ("burgers", {0.0: {("L2", "u"): 0.354012},
                 0.001: {("L2", "u"): 0.329584},
                 0.002: {("L2", "u"): 0.313885},
                 0.004: {("L2", "u"): 0.291375}}),
    # vdns/channel at 50x10 (tests/test_vdns_gold.py)
    ("vdns", {0.0: {("L2", "ux"): 0.0019421, ("L2", "pr"): 0.0128887,
                    ("L2", "uy"): 8.18291e-05}}),
    # porous/2D_verification at 40^2 (tests/test_solid_sw_porous.py)
    ("porous", {0.0: {("L2", "p"): 0.00102776,
                      ("L2-grad", "p"): 0.201394}}),
])
def test_reference_gold(name, times):
    """The reference's golds (rtol 2e-5) on the port alone."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = {"burgers": lambda: cs.burgers_deck(100, dim=1),
           "vdns": lambda: cs.vdns_deck(50, 10),
           "porous": lambda: cs.porous_deck(40)}[name]()
    res = Problem(cfg, device="cpu").run()
    hist = {round(t, 10): e for t, e in res.error_history}
    for t, want in times.items():
        for key, gold in want.items():
            assert hist[t][key] == pytest.approx(gold, rel=2e-5), (t, key)
    if name == "vdns":
        assert hist[0.0][("L2", "T")] < 1e-14
    if name == "porous":
        assert hist[0.0][("L2-face", "p")] == pytest.approx(0.0017603,
                                                             rel=2e-4)


def test_hartmann_analytic_gold():
    """hartmann/analytical_solve: the analytic solution's L2 at NX = 500
    (rtol 1e-4, tests/test_hartmann_gold.py) and h^2 convergence from
    250."""
    from mrhyde_tpu_torch.problem import Problem
    e250 = Problem(cs.hartmann_deck(250), device="cpu").run().errors
    e500 = Problem(cs.hartmann_deck(500), device="cpu").run().errors
    assert e500[("L2", "u")] == pytest.approx(1.126126e-06, rel=1e-4)
    assert e500[("L2", "b")] == pytest.approx(1.062206e-06, rel=1e-4)
    for v in ("u", "b"):
        assert 3.8 < e250[("L2", v)] / e500[("L2", v)] < 4.2


def test_shallowwater_droptest_gold():
    """shallowwater/droptest at 40^2: L2(H) 1.00321 (rtol 2e-5) and
    L2(Hv) 0.0121219 (2e-4) at t = 0.005."""
    from mrhyde_tpu_torch.problem import Problem
    res = Problem(cs.shallowwater_deck(40), device="cpu").run()
    hist = {round(t, 10): e for t, e in res.error_history}
    assert hist[0.005][("L2", "H")] == pytest.approx(1.00321, rel=2e-5)
    assert hist[0.005][("L2", "Hv")] == pytest.approx(0.0121219, rel=2e-4)


def test_vdns_default_density_needs_p0():
    """VDNS's default density p0/(RGas T) reads the parameter p0: a deck
    without Parameters and without 'rho' fails on that leaf in both
    packages alike (KeyError)."""
    cfg = cs.vdns_deck(4, 2)
    del cfg["Parameters"]
    del cfg["Functions"]["rho"]
    pj, pt = both_problems(cfg)
    with pytest.raises(KeyError, match="p0"):
        pj.run()
    with pytest.raises(KeyError, match="p0"):
        pt.run()


def test_msphasefield_prints_its_legacy_note_once(capsys):
    """Without the setting, the parity default prints JAX's one-time
    note on the first assembly, and not again."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = cs.phasefield_deck(4)
    del cfg["Physics"]["legacy first-qp sampling"]
    p = Problem(cfg, device="cpu")
    u = p.initial_state()
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    tc = TimeCoeffs.steady(p.n_dof)
    p.assembler.residual(u, tc)
    p.assembler.residual(u, tc)
    out = capsys.readouterr().out
    assert out.count("msphasefield: reproducing") == 1


A10_NAMES = ["Burgers", "shallow water", "shallow ice", "helmholtz",
             "hartmann", "Kuramoto-Sivashinsky", "llamas", "msphasefield",
             "phasesolidification", "VDNS", "inc sat", "porous", "cns",
             "physicsTest"]


@pytest.mark.parametrize("name", A10_NAMES)
def test_a10_modules_build(name):
    """Each of A10's deck names builds in the port, with the JAX
    module's variables, in 2D and (but for shallow water) in 3D."""
    from mrhyde_tpu.physics.registry import import_physics as jax_import
    from mrhyde_tpu_torch.physics.registry import import_physics
    for dim in (2, 3) if name != "shallow water" else (2,):
        settings = {"number_phases": 2}
        (mt,), (mj,) = (import_physics(name, settings, dim),
                        jax_import(name, settings, dim))
        assert mt.variables() == mj.variables()


def test_only_a11_modules_are_left():
    """No module is left: with those of vector and trace bases (A11),
    the Euler deck name among them, every deck name the JAX package
    registers is one of the port's."""
    from mrhyde_tpu.physics.registry import available_modules as jax_names
    from mrhyde_tpu_torch.physics.registry import available_modules
    assert "Euler" in available_modules()
    assert set(jax_names()) == set(available_modules())
