"""Multi-set decks in mrhyde_tpu_torch (`multiset.py`, `make_problem`)
against the JAX package on the CPU in f64: the ODE + CDR deck with a
time scheme per set (the reference's MultiSet_different_timescheme on an
internal mesh), the iteratively coupled NS + cdr start-up (each set
reading the other's fields), with the fused providers reading those
fields as element-varying coefficients and agreeing with the general
path, and a steady Picard-coupled pair with 'max subcycles'."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402

torch.set_num_threads(1)

# the JAX package's tests/test_multiset.py deck: q' = -q by BDF3 after
# five RK-4,4 start-up steps, cdr with unit reaction by RK-4,4
ODE_CDR = {
    "Mesh": {"dimension": 2, "element type": "quad", "NX": 3, "NY": 3},
    "Functions": {"ODE source": "-1.0*q"},
    "Physics": {
        "physics set names": "ODE, CDR",
        "ODE": {"modules": "ODE",
                "Initial conditions": {"scalar data": True, "q": 1.0}},
        "CDR": {"modules": "cdr"},
    },
    "Discretization": {
        "ODE": {"order": {"q": 1}, "quadrature": 2},
        "CDR": {"order": {"c": 1}, "quadrature": 2},
    },
    "Solver": {
        "solver": "transient", "transient BDF order": 1,
        "transient Butcher tableau": "BWE", "nonlinear TOL": 1e-7,
        "max nonlinear iters": 2, "final time": 0.01,
        "number of steps": 8, "use direct solver": True,
        "ODE": {"transient Butcher tableau": "BWE",
                "transient BDF order": 3,
                "transient startup BDF order": 1,
                "transient startup Butcher tableau": "RK-4,4",
                "transient startup steps": 5},
        "CDR": {"transient Butcher tableau": "RK-4,4"},
    },
    "Analysis": {"analysis type": "forward"},
    "Postprocess": {"compute errors": True,
                    "True solutions": {"q": "1.0*exp(-1.0*t)", "c": "0.0"}},
}


def _both(cfg):
    from mrhyde_tpu.problem import make_problem as jmake
    from mrhyde_tpu_torch.problem import make_problem
    pj = jmake(copy.deepcopy(cfg))
    pt = make_problem(copy.deepcopy(cfg), device="cpu")
    return pj, pt, pj.run(), pt.run()


def _same_history(rj, rt, rtol):
    """Every recorded L2 to rtol; a norm at round-off (q's error under
    the exact RK-4,4 start-up, 1e-16) to 1e-14."""
    assert len(rt.error_history) == len(rj.error_history)
    for (tj, ej), (tt, et) in zip(rj.error_history, rt.error_history):
        assert tt == pytest.approx(tj)
        assert sorted(et) == sorted(ej)
        for k in ej:
            assert abs(float(et[k]) - float(ej[k])) <= rtol * abs(
                float(ej[k])) + 1e-14, (tt, k)


def test_different_timeschemes_match_jax():
    from mrhyde_tpu_torch.multiset import MultiSetProblem
    pj, pt, rj, rt = _both(ODE_CDR)
    assert isinstance(pt, MultiSetProblem) and pt.set_names == ["ODE", "CDR"]
    _same_history(rj, rt, 1e-10)
    hist = {round(t, 10): e for t, e in rt.error_history}
    # c integrates dc/dt = -1 exactly with RK-4,4 (the reference's gold)
    assert np.isclose(hist[0.01][("L2", "c")], 0.01, rtol=1e-6)
    assert hist[0.01][("L2", "q")] < 5e-12


def test_ns_cdr_iteratively_coupled_matches_jax(monkeypatch):
    """The start-up of chip_smoke's ns_cdr_multiset_deck at 16x4: NS on
    the NS provider (its source reads the cdr set's c), cdr on the
    thermal provider's affine split (its velocity the NS set's ux, uy),
    every assembly fused; JAX's general path to 1e-9, and the port's
    general path to 1e-10."""
    from mrhyde_tpu_torch.ops.fused_ns import FusedNSAssembly
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    from mrhyde_tpu_torch.problem import make_problem
    cfg = cs.ns_cdr_multiset_deck(16)
    pj, pt, rj, rt = _both(cfg)
    ns, cdr = (p.assembler.fused_provider() for p in pt.sets)
    assert type(ns) is FusedNSAssembly and type(cdr) is FusedP1Assembly
    assert ns.varying[2] and cdr.split and cdr._varying["velocity"]
    assert pt.sets[0].assembler.field_leaves == {"c"}
    assert pt.sets[1].assembler.field_leaves == {"ux", "uy", "pr"}
    _same_history(rj, rt, 1e-9)
    general = make_problem(copy.deepcopy(cfg), device="cpu")
    for p in general.sets:
        monkeypatch.setattr(p.assembler, "fused_provider", lambda: None)
    rg = general.run()
    for ut, ug in zip(rt.u, rg.u):
        assert float(torch.abs(ut - ug).max()) <= 1e-10 * float(
            torch.abs(ug).max())


def test_steady_picard_sweeps_match_jax():
    """Two steady sets coupled by 'max subcycles: 3': thermal whose
    source reads the cdr set's c, cdr whose reaction reads e."""
    cfg = {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": 4, "NY": 4},
        "Functions": {"thermal source": "1.0 + c*c", "thermal diffusion":
                      "1.0", "diffusion": "0.5", "xvel": "0.0",
                      "yvel": "0.0", "reaction": "e*c", "source": "1.0"},
        "Physics": {
            "physics set names": "T, C",
            "T": {"modules": "thermal", "Dirichlet conditions": {
                "scalar data": True, "e": {"all boundaries": 0.0}}},
            "C": {"modules": "cdr", "Dirichlet conditions": {
                "scalar data": True, "c": {"all boundaries": 0.0}}}},
        "Discretization": {"T": {"order": {"e": 1}, "quadrature": 2},
                           "C": {"order": {"c": 1}, "quadrature": 2}},
        "Solver": {"solver": "steady-state", "max subcycles": 3},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "0.0", "c": "0.0"}},
    }
    _pj, _pt, rj, rt = _both(cfg)
    _same_history(rj, rt, 1e-11)
    for ut, uj in zip(rt.u, rj.u):
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=1e-11,
                                   atol=1e-15)
