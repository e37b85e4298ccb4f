"""The port's time integration (mrhyde_tpu_torch/solvers/
time_integration.py) and transient Problem path, against the JAX
package and the reference golds embedded in the repo's tests.

Tolerances: tableaus and BDF weights exactly (the same numpy
arithmetic); the ODE and thermal golds at rtol 2e-5 (the printed
6-digit gold, as tests/test_ode_integrators.py holds JAX); the error
history at 1e-10 absolute against JAX's live f64 run (the same
discretization, solver and stage arithmetic, summed in another order)."""

import numpy as np
import pytest
import torch

from mrhyde_tpu.solvers import time_integration as jti
from mrhyde_tpu_torch.solvers import time_integration as tti
from test_ode_integrators import GOLD, make_cfg
from torch_port_utils import both_problems, transient_cfg

torch.set_num_threads(1)

TABLEAUS = ("BWE", "DIRK-1,1", "FWE", "CN", "SSPRK-3,3", "RK-4,4",
            "DIRK-1,2", "DIRK-2,2", "DIRK-2,3", "DIRK-3,3", "leap-frog",
            "custom")
CUSTOM = (np.array([[0.0, 0.0], [0.5, 0.0]]), np.array([0.3, 0.7]),
          np.array([0.0, 0.5]))


@pytest.mark.parametrize("name", TABLEAUS)
def test_butcher_tableau_matches_jax(name):
    for a, b in zip(tti.butcher_tableau(name, CUSTOM),
                    jti.butcher_tableau(name, CUSTOM)):
        assert np.array_equal(a, b)
    with pytest.raises(ValueError):
        tti.butcher_tableau("RK-9,9")


@pytest.mark.parametrize("order", range(1, 7))
def test_bdf_weights_match_jax(order):
    assert np.array_equal(tti.bdf_weights(order), jti.bdf_weights(order))
    assert np.array_equal(tti.bdf_weights(order, transient=False),
                          jti.bdf_weights(order, transient=False))


def _history(res, var):
    return dict((round(t, 10), errs[("L2", var)])
                for t, errs in res.error_history)


@pytest.mark.parametrize("name", sorted(GOLD))
def test_ode_integrator_golds_through_port(name):
    from mrhyde_tpu_torch.problem import Problem
    overrides, gold09, gold10 = GOLD[name]
    hist = _history(Problem(make_cfg(overrides), device="cpu").run(), "q")
    assert hist[0.9] == pytest.approx(gold09, rel=2e-5)
    assert hist[1.0] == pytest.approx(gold10, rel=2e-5)


@pytest.mark.parametrize("lump", [True, False])
def test_fully_explicit_rk44_through_port(lump):
    """The explicit stage: lumped mass (the gold) and the consistent mass
    through pcg_reference (held to JAX's run of the same deck)."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.problem import Problem
    cfg = make_cfg({"transient Butcher tableau": "RK-4,4",
                    "fully explicit": True, "lump mass": lump})
    hist = _history(Problem(cfg, device="cpu").run(), "q")
    if lump:
        assert hist[0.9] == pytest.approx(3.31459e-07, rel=2e-5)
        assert hist[1.0] == pytest.approx(3.33241e-07, rel=2e-5)
    ref = _history(JaxProblem(cfg).run(), "q")
    for t, e in ref.items():
        assert abs(hist[t] - e) < 1e-10


# (tableau overrides, kappa, (density, specific heat)): BWE leaves beta_u
# at 0; DIRK-2,2 has alpha_u = 0.5 and beta_u != 0; CN's stage 0 has
# alpha_u = 0; BDF2 carries two history terms in beta_t (and self-starts
# by the reference's defaults)
HISTORY_CASES = {
    "BWE": ({"transient Butcher tableau": "BWE"}, "1.0", ("1.0", "1.0")),
    "DIRK-2,2": ({"transient Butcher tableau": "DIRK-2,2"},
                 "1.0 + 0.5*x*y", ("2.0", "1.0 + 0.5*x")),
    "CN": ({"transient Butcher tableau": "CN"}, "1.0 + 0.5*x*y",
           ("1.0", "1.0")),
    "BDF2": ({"transient BDF order": 2}, "1.0 + e*e",
             ("2.0", "1.0 + 0.5*x")),
}


@pytest.mark.parametrize("name", sorted(HISTORY_CASES))
def test_error_history_matches_jax(name):
    overrides, kappa, mass = HISTORY_CASES[name]
    cfg = transient_cfg(6, 5, kappa=kappa, mass=mass, ic="x*(1-x)*y",
                        solver=dict({"nonlinear TOL": 1e-12}, **overrides))
    pj, pt = both_problems(cfg)
    calls = []
    fused = pt.assembler.fused_provider()
    res_jac = fused.res_jac

    def counted(*a, **k):
        calls.append(1)
        return res_jac(*a, **k)
    fused.res_jac = counted
    ht = pt.run().error_history
    hj = pj.run().error_history
    assert calls, "the transient run never engaged the fused provider"
    assert fused.stats["steady"] is False
    assert [t for t, _ in ht] == pytest.approx([t for t, _ in hj],
                                               abs=1e-14)
    assert len(ht) == 5
    for (_, et), (_, ej) in zip(ht, hj):
        assert abs(et[("L2", "e")] - ej[("L2", "e")]) < 1e-10


def test_transient_gold_deck_through_port():
    """The reference's 2D transient thermal deck (tests/
    test_thermal_family.py): NX=NY=40, BWE, 20 steps to t=1."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = transient_cfg(40, solver={
        "transient Butcher tableau": "BWE", "transient BDF order": 1,
        "final time": 1.0, "number of steps": 20, "nonlinear TOL": 1e-7,
        "max nonlinear iters": 2})
    hist = _history(Problem(cfg, device="cpu").run(), "e")
    assert hist[0.9] == pytest.approx(0.00509256, rel=2e-5)
    assert hist[1.0] == pytest.approx(0.00118468, rel=2e-5)


def test_step_cut_retries_with_half_dt(monkeypatch):
    """A stage whose Newton solve fails (norm above norm0) halves dt and
    retries from the same state, up to max_cuts."""
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.solvers.nonlinear import NewtonResult
    pt = Problem(transient_cfg(4), device="cpu")
    dts = []

    def flaky(asm, z0, tc, *a, **k):
        dts.append(tc.deltat)
        ok = len(dts) > 2
        return NewtonResult(z0, 1, 1.0, 0.5 if ok else 2.0, ok)
    monkeypatch.setattr(tti, "newton_solve", flaky)
    integ = tti.TransientIntegrator(pt.assembler, max_cuts=3)
    seen = []
    u, t = integ.run(pt.initial_state(), t0=0.0, t_end=0.1, dt=0.1,
                     observer=lambda u, tt, s: seen.append(tt))
    assert dts[:3] == [0.1, 0.05, 0.025]
    assert seen[0] == 0.0 and t == pytest.approx(0.1)
