"""The Parameters sublist in mrhyde_tpu_torch (`analysis/parameters.py`)
against the JAX package on the CPU in f64: the ParameterManager's specs
and views for scalar, vector, active, stochastic and file-sourced
parameters; discretized parameters and the analyses, which build since
ROADMAP A12 was ported; decks whose coefficients read parameters on the fused
providers (the B2 thermal kernel's plain version, the NS node kernel's,
the module-set path) and on the general path; a vector parameter read
by index; and the lookup order that puts a function before a parameter
of the same name (Hartmann's hartmannNum)."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (channel_cfg, solve_both,  # noqa: E402
                              thermal_cdr_cfg, thermal_cfg)

torch.set_num_threads(1)


def sublist(tmp_path):
    """A Parameters sublist of every kind the forward path reads: plain
    numbers, scalars and vectors of each usage, a vector from a text
    file, and a discretized field (left out of the views)."""
    src = tmp_path / "kl_coeffs.dat"
    np.savetxt(src, np.array([[0.5, -0.25], [0.125, 2.0]]))
    return {
        "plain": 3.5,
        "k0": {"type": "scalar", "value": 1.25, "usage": "inactive"},
        "ka": {"type": "scalar", "value": 0.5, "usage": "active",
               "min": -1.0, "max": 2.0},
        "kv": {"type": "vector", "value": [1.0, 0.5, 0.25],
               "usage": "active", "lower_bound": 0.0, "upper_bound": 3.0},
        "one": {"type": "vector", "value": 2.0, "usage": "inactive"},
        "ks": {"type": "scalar", "value": 0.1, "usage": "stochastic",
               "distribution": "normal", "mean": 0.2, "variance": 0.05},
        "kl": {"type": "vector", "source": str(src), "usage": "active"},
        "field": {"type": "HGRAD", "order": 1, "initial_value": 0.3,
                  "usage": "discretized", "dynamic": True},
    }


def test_specs_and_views_match_jax(tmp_path):
    from mrhyde_tpu.analysis.parameters import ParameterManager as JaxPM
    from mrhyde_tpu_torch.analysis.parameters import ParameterManager
    cfg = sublist(tmp_path)
    pj, pt = JaxPM(copy.deepcopy(cfg)), ParameterManager(copy.deepcopy(cfg))
    assert list(pt.specs) == list(pj.specs)
    for name, sj in pj.specs.items():
        st = pt.specs[name]
        for f in ("name", "usage", "distribution", "mean", "variance",
                  "min", "max", "basis", "order", "dynamic"):
            assert getattr(st, f) == getattr(sj, f), (name, f)
        assert np.ndim(st.value) == np.ndim(sj.value)
        np.testing.assert_array_equal(st.value, sj.value)
    assert pt.discretized_names() == pj.discretized_names() == ["field"]
    assert pt.active_names() == pj.active_names()
    assert pt.stochastic_names() == pj.stochastic_names() == ["ks"]
    vj, vt = pj.all_values(), pt.all_values()
    assert list(vt) == list(vj)
    for name, v in vj.items():
        if np.ndim(v) == 0:
            assert isinstance(vt[name], float) and vt[name] == v
        else:
            assert isinstance(vt[name], torch.Tensor)
            assert vt[name].dtype == torch.float64
            np.testing.assert_array_equal(vt[name].numpy(), v)
    lo_j, hi_j = pj.bounds()
    lo_t, hi_t = pt.bounds()
    np.testing.assert_array_equal(lo_t, lo_j)
    np.testing.assert_array_equal(hi_t, hi_j)


def test_pvec_flatten_unflatten_match_jax(tmp_path):
    """The active parameters as tensors, their flat vector and its
    inverse (the field's dynamic value taken as one per-step row)."""
    from mrhyde_tpu.analysis.parameters import ParameterManager as JaxPM
    from mrhyde_tpu_torch.analysis.parameters import ParameterManager
    cfg = sublist(tmp_path)
    del cfg["field"]
    pj, pt = JaxPM(copy.deepcopy(cfg)), ParameterManager(copy.deepcopy(cfg))
    pvj, pvt = pj.pvec(), pt.pvec()
    assert list(pvt) == list(pvj) == ["ka", "kv", "kl"]
    for name in pvj:
        np.testing.assert_array_equal(pvt[name].numpy(),
                                      np.asarray(pvj[name]))
    fj, ft = pj.flatten(pvj), pt.flatten(pvt)
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    uj, ut = pj.unflatten(np.asarray(fj)), pt.unflatten(ft)
    for name in uj:
        np.testing.assert_array_equal(np.asarray(ut[name]),
                                      np.asarray(uj[name]))
    pt.update({"ka": 0.75})
    assert pt.all_values()["ka"] == 0.75


@pytest.mark.parametrize("cfg_patch,what", [
    ({"Parameters": {"kp": {"type": "HGRAD", "usage": "discretized",
                            "initial_value": 1.0}}}, "discretized"),
    ({"Analysis": {"analysis type": "ROL"}}, "analysis type"),
    ({"Analysis": {"analysis type": "UQ"}}, "analysis type"),
    ({"Analysis": {"analysis type": "dry run"}}, "analysis type"),
])
def test_a12_features_still_raise(cfg_patch, what):
    """ROADMAP A12 is ported: the decks that raised naming it build in
    both packages (the field parameter gets its own DOF map and start
    value), and the analyses dispatch through AnalysisManager."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.analysis.manager import AnalysisManager
    from mrhyde_tpu_torch.problem import Problem
    cfg = thermal_cfg(4)
    cfg.update(cfg_patch)
    pj, pt = JaxProblem(copy.deepcopy(cfg)), Problem(cfg, device="cpu")
    assert sorted(pt.assembler.field_params) == \
        sorted(pj.assembler.field_params)
    for name, fp in pt.assembler.field_params.items():
        assert fp["n_dof"] == pj.assembler.field_params[name]["n_dof"]
        np.testing.assert_array_equal(pt.param_manager.specs[name].value,
                                      pj.param_manager.specs[name].value)
    assert AnalysisManager(pt).mode == (cfg.get("Analysis") or {}).get(
        "analysis type", "forward")
    assert what in ("discretized", "analysis type")


def test_thermal_coefficients_read_parameters():
    """kappa = k0 + k1 e e from two inactive parameters: the B2 "full"
    provider (its plain version here) with JAX's solution, and the same
    solution as kappa = 1 + e e written out."""
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    from mrhyde_tpu_torch.problem import Problem
    _, rt, pt = solve_both(cs.params_thermal_deck(8))
    assert type(pt.assembler.fused_provider()) is FusedP1Assembly
    assert pt.params == {"k0": 1.0, "k1": 1.0}
    ref = Problem(cs.nonlinear_deck(8), device="cpu").run()
    assert torch.allclose(rt.u, ref.u, rtol=0, atol=1e-13)


def test_ns_coefficients_read_an_active_parameter():
    """The channel with viscosity and source ux the active parameter nu
    = 0.5 (the Poiseuille flow of nu = 1): the NS node provider with
    JAX's solution."""
    from mrhyde_tpu_torch.ops.fused_ns import FusedNSAssembly
    _, rt, pt = solve_both(cs.params_ns_deck(16))
    assert type(pt.assembler.fused_provider()) is FusedNSAssembly
    assert pt.params == {"nu": 0.5}


def _vector_decks():
    """Decks whose coefficients read the vector parameter kv = (1, 0.5,
    2) by index: thermal on B2 (kappa, a transient stage's mass), NS on
    the node provider (viscosity), thermal + cdr on the module-set path
    and cdr on hex (B1)."""
    kv = {"kv": {"type": "vector", "value": [1.0, 0.5, 2.0],
                 "usage": "inactive"}}
    thermal = thermal_cfg(6, kappa="kv(0) + kv(1)*x*y")
    transient = cs.transient_deck(6, {"final time": 0.1,
                                      "number of steps": 2},
                                  kappa="kv(0) + kv(1)*x")
    transient["Functions"]["density"] = "kv(2)"
    ns = channel_cfg(10, 4)
    ns["Functions"]["viscosity"] = "kv(0) + kv(1)*kv(1)"
    ns["Solver"]["use direct solver"] = True
    tcdr = thermal_cdr_cfg("kv(0) + 0.1*x")
    hexcdr = cs.cdr_deck(3, reaction="kv(1)*c", vel=("2.0", "1.0", "0.5"),
                         mesh="hex")
    out = {"thermal": thermal, "thermal_transient": transient, "ns": ns,
           "thermal_cdr": tcdr, "cdr_hex": hexcdr}
    for cfg in out.values():
        cfg["Parameters"] = copy.deepcopy(kv)
    return out


@pytest.mark.parametrize("name", ["thermal", "thermal_transient", "ns",
                                  "thermal_cdr", "cdr_hex"])
def test_vector_parameter_runs_as_in_jax(name):
    """A deck with a vector parameter runs where JAX's does, with JAX's
    solution (the fused providers key their caches by its values)."""
    _, rt, pt = solve_both(_vector_decks()[name])
    assert isinstance(pt.params["kv"], torch.Tensor)
    fused = pt.assembler.fused_provider()
    if name in ("thermal", "thermal_transient", "ns", "cdr_hex"):
        assert fused is not None


def test_fused_cache_keys_hold_vectors():
    """params_key: scalars by value, vectors (tensors or arrays) by the
    tuple of their values, so two vectors that differ key apart."""
    from mrhyde_tpu_torch.ops.fused_p1 import params_key
    a = params_key({"k": 1.0, "v": torch.tensor([1.0, 2.0])})
    assert a == (("k", 1.0), ("v", (1.0, 2.0)))
    assert a == params_key({"v": np.array([1.0, 2.0]), "k": 1})
    assert a != params_key({"k": 1.0, "v": torch.tensor([1.0, 2.5])})


@pytest.mark.parametrize("ha", [1.0, 2.0])
def test_hartmann_function_comes_before_the_parameter(ha):
    """Hartmann registers the function hartmannNum (1.0) and the deck
    also has a parameter of that name: both packages read the function,
    so the solution and its norms are the same for the parameter 1 and
    2, and equal JAX's."""
    from mrhyde_tpu_torch.problem import Problem
    _, rt, pt = solve_both(cs.hartmann_deck(20, ha=ha))
    assert pt.params["hartmannNum"] == ha
    ref = Problem(cs.hartmann_deck(20), device="cpu").run()
    assert torch.equal(rt.u, ref.u)


def test_parameters_reach_boundary_and_error_expressions():
    """A parameter read by a Neumann condition (a side expression) and by
    the true solution (the error calculator): the port's norms are
    JAX's."""
    cfg = cs.mixed_neumann_deck(8)
    cfg["Physics"]["Neumann conditions"]["e"] = {
        side: f"amp*({expr})" for side, expr in
        cfg["Physics"]["Neumann conditions"]["e"].items()}
    cfg["Functions"]["thermal source"] = \
        f"amp*({cfg['Functions']['thermal source']})"
    cfg["Postprocess"]["True solutions"]["e"] = \
        f"amp*({cfg['Postprocess']['True solutions']['e']})"
    cfg["Parameters"] = {"amp": {"type": "scalar", "value": 2.0}}
    solve_both(cfg)
