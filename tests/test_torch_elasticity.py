"""Linear and crystal elasticity in mrhyde_tpu_torch
(`physics/linearelasticity.py`, `physics/crystal_elasticity.py`) against
the JAX package on the CPU in f64: the reference's le/2D_manufactured
(its gold at 40^2, JAX's solution at 8^2), 3D hex with a Neumann
traction, crystal elasticity (isotropic constants equal linear
elasticity; grain rotations read from a mesh data file, in 2D and 3D),
and a small thermoelastic transient deck. Elasticity has no fused kernel
in either package: every deck here takes the general path."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (both_problems, le_cfg,  # noqa: E402
                              write_grain_files)

torch.set_num_threads(1)


def _solve_both(cfg, rtol=1e-11):
    """Both packages' runs: solutions within rtol (of max |u|), every
    norm at every recorded time within rtol; returns the port's."""
    pj, pt = both_problems(cfg)
    assert pt.assembler.fused_provider() is None
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= rtol * np.max(np.abs(uj))
    assert len(rt.error_history) == len(rj.error_history)
    for (_, ej), (_, et) in zip(rj.error_history, rt.error_history):
        assert set(et) == set(ej)
        for key, val in ej.items():
            assert abs(et[key] - val) <= rtol * abs(val), key
    return rt


def test_le_manufactured_gold():
    """le/2D_manufactured at 40^2: L2(dx) 0.000770252, L2(dy) 0.00121848
    (the reference's gold, rtol 2e-5)."""
    from mrhyde_tpu_torch.problem import Problem
    res = Problem(le_cfg(40), device="cpu").run()
    assert np.isclose(res.errors[("L2", "dx")], 0.000770252, rtol=2e-5)
    assert np.isclose(res.errors[("L2", "dy")], 0.00121848, rtol=2e-5)


def test_le_manufactured_matches_jax():
    _solve_both(le_cfg(8))


def hex_traction_cfg(n=3, module="linearelasticity"):
    """An n^3 hex block clamped on the left face and pulled on the right
    face by the traction (1, 0.5 y, 0.25 z), with a body force; the
    norms are the displacements' (true solutions 0)."""
    disp = {"dx": 0.0, "dy": 0.0, "dz": 0.0}
    return {
        "Mesh": {"dimension": 3, "element type": "hex", "NX": n, "NY": n,
                 "NZ": n},
        "Physics": {"modules": module,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        **{v: {"left": 0.0} for v in disp}},
                    "Neumann conditions": {
                        "dx": {"right": "1.0"}, "dy": {"right": "0.5*y"},
                        "dz": {"right": "0.25*z"}}},
        "Functions": {"lambda": "1.5", "mu": "0.75 + 0.25*x",
                      "source dz": "-0.1"},
        "Discretization": {"order": {v: 1 for v in disp}, "quadrature": 2},
        "Solver": {"solver": "steady-state", "max nonlinear iters": 2},
        "Postprocess": {"compute errors": True,
                        "True solutions": {v: "0.0" for v in disp}},
    }


def test_hex_neumann_traction_matches_jax():
    pj, pt = both_problems(hex_traction_cfg())
    assert pt.assembler._active_bnd_groups()
    _solve_both(hex_traction_cfg())


def crystal_cfg(n, dim=2, params=None, data=None):
    """Crystal elasticity on an n^dim box clamped on all boundaries with a
    body force; `params` the 'Crystal elastic parameters' sublist, `data`
    the directory holding the grain files (rotations per element)."""
    names = ["dx", "dy", "dz"][:dim]
    cfg = {
        "Mesh": {"dimension": dim, "element type": "quad" if dim == 2
                 else "hex", "NX": n, "NY": n},
        "Functions": {"source dx": "1.0", "source dy": "0.5",
                      "source dz": "-0.25", "lambda": "1.0", "mu": "0.5"},
        "Physics": {"modules": "crystal elasticity",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        **{v: {"all boundaries": 0.0} for v in names}}},
        "Discretization": {"order": {v: 1 for v in names}},
        "Solver": {"solver": "steady-state", "max nonlinear iters": 2},
        "Postprocess": {"compute errors": True,
                        "True solutions": {v: "0.0" for v in names}},
    }
    if dim == 3:
        cfg["Mesh"]["NZ"] = n
    if params:
        cfg["Physics"]["Crystal elastic parameters"] = params
    if data is not None:
        cfg["Mesh"].update({"data file": "mesh_data",
                            "have mesh data rotations": True})
        cfg["_deck_dir"] = str(data)
    return cfg


def test_crystal_isotropic_equals_linear_elasticity():
    """C11 = lambda + 2 mu, C12 = lambda, C44 = mu contract to isotropic
    linear elasticity (tests/test_physics_smoke.py:155-188), and each
    deck matches JAX's."""
    crystal = crystal_cfg(6, params={"C11": 2.0, "C12": 1.0, "C44": 0.5})
    le = copy.deepcopy(crystal)
    le["Physics"]["modules"] = "linearelasticity"
    del le["Physics"]["Crystal elastic parameters"]
    u_le = _solve_both(le).u.numpy()
    u_ce = _solve_both(crystal).u.numpy()
    np.testing.assert_allclose(u_le, u_ce, rtol=1e-10, atol=1e-12)


def test_crystal_reference_defaults():
    """The reference's defaults (E = 1, nu = 0.4; C44 = 2 mu, not
    isotropic) and the tensor's fill quirk, as JAX's."""
    from mrhyde_tpu.physics.crystal_elasticity import (
        CrystalElasticity as JaxCE)
    from mrhyde_tpu_torch.physics.crystal_elasticity import (
        CrystalElasticity)
    for dim in (2, 3):
        mt, mj = CrystalElasticity({}, dim), JaxCE({}, dim)
        assert (mt.c11, mt.c12, mt.c44) == (mj.c11, mj.c12, mj.c44)
        assert np.array_equal(mt.C_ref, mj.C_ref)
    _solve_both(crystal_cfg(5))


@pytest.mark.parametrize("dim", [2, 3])
def test_crystal_rotations_from_a_mesh_data_file(tmp_path, dim):
    """Grain rotations (seeded, 9 columns per grain) from mesh data files:
    each element takes its nearest grain's rotation, the stiffness
    rotated per element ("crystal_C", (E, dim^4)) as JAX's, and the solve
    matches JAX's to 1e-11."""
    write_grain_files(tmp_path, 7, dim, seed=11 + dim)
    cfg = crystal_cfg(6 if dim == 2 else 3, dim, data=tmp_path)
    pj, pt = both_problems(cfg)
    ct = pt.assembler.extra_elem_fields["crystal_C"].numpy()
    cj = np.asarray(pj.assembler.extra_elem_fields["crystal_C"])
    assert ct.shape == (pt.mesh.n_elem, dim ** 4)
    assert np.array_equal(ct, cj)
    assert len(np.unique(ct, axis=0)) > 1
    _solve_both(cfg)


def thermoelastic_cfg(n=5):
    """Thermal and linear elasticity in one set (the coupling
    -alpha_T (3 lambda + 2 mu) e I in the stress), transient from rest:
    BWE, 3 steps of 0.1; e heated by a source, 0 on the boundary; the
    displacements clamped on the left and right."""
    disp = ("dx", "dy")
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": n, "NY": n},
        "Functions": {"thermal source": "10*sin(pi*x)*sin(pi*y)",
                      "lambda": "1.0", "mu": "0.5", "alpha_T": "0.01",
                      "source dy": "-0.1"},
        "Physics": {"modules": "thermal, linearelasticity",
                    "T_ambient": 0.2,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {"all boundaries": 0.0},
                        **{v: {"left": 0.0, "right": 0.0} for v in disp}},
                    "Initial conditions": {"scalar data": True, "e": 0.0,
                                           "dx": 0.0, "dy": 0.0}},
        "Discretization": {"order": {"e": 1, "dx": 1, "dy": 1},
                           "quadrature": 2},
        "Solver": {"solver": "transient", "final time": 0.3,
                   "number of steps": 3, "nonlinear TOL": 1e-10},
        "Postprocess": {"compute errors": True,
                        "True solutions": {"e": "0.0", "dx": "0.0",
                                           "dy": "0.0"}},
    }


def test_thermoelastic_transient_matches_jax():
    rt = _solve_both(thermoelastic_cfg())
    assert len(rt.error_history) == 4
    assert rt.errors[("L2", "dx")] > 0


def test_elasticity_modules_are_registered():
    from mrhyde_tpu_torch.physics.registry import available_modules
    for name in ("linearelasticity", "crystal elasticity"):
        assert name in available_modules()
