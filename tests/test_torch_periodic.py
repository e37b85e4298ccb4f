"""Periodic meshes (deck key 'Periodic BCs') in mrhyde_tpu_torch against
the JAX package on the CPU in f64: the dof identification, the route (no
structured plan, so the general path, as JAX's), the reference's
cdr/periodic deck (its gold at 40^2, JAX's history at a smaller size)
and JAX's periodic hex thermal deck (tests/test_periodic.py)."""

import copy

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import both_problems  # noqa: E402

torch.set_num_threads(1)

# the reference's cdr/periodic: a bubble advected along a strip periodic
# in x (tests/test_periodic.py:9-24)
CDR_PERIODIC = {
    "Mesh": {"dimension": 2, "element type": "quad", "NX": 40, "NY": 40,
             "Periodic BCs": {"Count": 1,
                              "Periodic Condition 1":
                                  "y-all 1e-8: left;right"}},
    "Functions": {"source": "0.0", "diffusion": "0.5", "xvel": "10.0",
                  "yvel": "0.0", "reaction": "0.0", "SUPG tau": "0.0",
                  "bubble": "-25.0*(x-0.7)*(x-0.7) - 25.0*(y-0.5)*(y-0.5)"},
    "Physics": {"modules": "cdr", "Initial conditions": {"c": "exp(bubble)"}},
    "Discretization": {"order": {"c": 1}, "quadrature": 2},
    "Solver": {"solver": "transient", "nonlinear TOL": 1e-7,
               "max nonlinear iters": 10, "final time": 1.0,
               "delta t": 0.1},
    "Postprocess": {"compute errors": True, "True solutions": {"c": "0.0"}},
}

HEX_PERIODIC = {
    "Mesh": {"dimension": 3, "element type": "hex", "NX": 8, "NY": 8,
             "NZ": 4,
             "Periodic BCs": {"Count": 1,
                              "Periodic Condition 1":
                                  "xy-all 1e-8: front;back"}},
    "Functions": {"thermal source": "8*(pi*pi)*sin(2*pi*x)*sin(2*pi*y)"},
    "Physics": {"modules": "thermal",
                "Dirichlet conditions": {"e": {"left": "0.0", "right": "0.0",
                                               "top": "0.0",
                                               "bottom": "0.0"}}},
    "Discretization": {"order": {"e": 1}, "quadrature": 2},
    "Solver": {"solver": "steady-state", "max nonlinear iters": 2},
    "Postprocess": {"compute errors": True,
                    "True solutions": {"e": "sin(2*pi*x)*sin(2*pi*y)"}},
}


def cdr_periodic(n, final_time=1.0):
    cfg = copy.deepcopy(CDR_PERIODIC)
    cfg["Mesh"]["NX"] = cfg["Mesh"]["NY"] = n
    cfg["Solver"]["final time"] = final_time
    return cfg


@pytest.mark.parametrize("cfg", [cdr_periodic(6), HEX_PERIODIC],
                         ids=["quad", "hex"])
def test_periodic_dofs_and_route_match_jax(cfg):
    """The identified dofs (lids, fixed dofs, dof count) equal JAX's; the
    mesh has no structured plan, so both packages take the general
    path."""
    pj, pt = both_problems(cfg)
    assert getattr(pt.mesh, "periodic", False)
    assert pt.n_dof == pj.n_dof < pt.mesh.n_nodes
    assert np.array_equal(pt.disc.lids, pj.disc.lids)
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)
    assert pt.assembler._structured is None
    assert pj.assembler._structured is None
    assert pt.assembler.fused_provider() is None


def test_cdr_periodic_history_matches_jax():
    """The periodic bubble at 12^2 over 0.3 time units: L2(c) at every
    step as JAX's to 1e-11."""
    pj, pt = both_problems(cdr_periodic(12, 0.3))
    hj, ht = pj.run().error_history, pt.run().error_history
    assert [round(t, 10) for t, _ in ht] == [round(float(t), 10)
                                              for t, _ in hj]
    for (_, ej), (_, et) in zip(hj, ht):
        v = ej[("L2", "c")]
        assert abs(et[("L2", "c")] - v) <= 1e-11 * abs(v)


def test_cdr_periodic_matches_gold():
    """cdr/periodic at 40^2: the reference's gold L2(c) at t = 0, 0.1 and
    1.0 (rtol 2e-5)."""
    from mrhyde_tpu_torch.problem import Problem
    res = Problem(cdr_periodic(40), device="cpu").run()
    hist = {round(t, 10): e[("L2", "c")] for t, e in res.error_history}
    assert np.isclose(hist[0.0], 0.250474, rtol=2e-5)
    assert np.isclose(hist[0.1], 0.131765, rtol=2e-5)
    assert np.isclose(hist[1.0], 0.123484, rtol=2e-5)


def test_periodic_hex_thermal_matches_jax():
    """A z-independent solution on a hex box periodic in z: the solution
    and L2(e) as JAX's to 1e-11, and JAX's test value 0.0255247."""
    pj, pt = both_problems(HEX_PERIODIC)
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= 1e-11 * np.max(np.abs(uj))
    v = rj.errors[("L2", "e")]
    assert abs(rt.errors[("L2", "e")] - v) <= 1e-11 * v
    assert np.isclose(rt.errors[("L2", "e")], 0.0255247, rtol=1e-3)
