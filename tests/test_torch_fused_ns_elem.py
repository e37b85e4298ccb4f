"""The port's fused Navier-Stokes provider on 2D p2 quads (nd = 27) and 3D
hex (p1, nd = 32), through the plain version of its element-tile kernel
(mrhyde_tpu_torch/ops/fused_ns.py `ns_elem_full_plain`), against the JAX
package's FusedP1Assembly.res_jac in Pallas interpret mode, which runs
the element-tile TPU kernel B1 (mode "full") on the CPU: the residual,
the kind of each Jacobian row (None / element-independent scalar / (E,)
array) and its value, and `stats`. p2: the JAX package's own deck
(tests/test_fused_p1.py, `test_ns_p2_transient_multivariable_matches_
general`) at a stage; its interpret-mode call takes minutes, so the
module computes it once. Hex: one 2x2x2 call, marked slow (JAX's
interpret-mode B1 takes several minutes more there). The other checks
of this provider are in test_torch_fused_ns_elem_rows.py.

Tolerance: 1e-10 absolute (the same f64 weak form and sparse forward
AD, other summation orders, entries up to O(10))."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
from mrhyde_tpu_torch.interop import state_from_numpy, time_coeffs_from_numpy
from torch_port_utils import (_kind, both_problems, check_fused_against_jax,
                              max_diff, ns_elem_cfg, seeded, steady_coeffs)

torch.set_num_threads(1)

TOL_JAX = 1e-10


def _jax_p2_cfg():
    """tests/test_fused_p1.py's p2 Navier-Stokes deck: 2x2 p2 quads,
    PSPG+SUPG, viscosity 0.05, quadrature 2, transient with dt 0.1."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": 2, "NY": 2},
        "Physics": {"modules": "navier stokes", "usePSPG": True,
                    "useSUPG": True,
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "ux": {"bottom": 0.0, "top": 1.0}}},
        "Functions": {"viscosity": "0.05"},
        "Discretization": {"order": {"ux": 2, "uy": 2, "pr": 2},
                           "quadrature": 2},
        "Solver": {"solver": "transient", "delta t": 0.1},
    }


@pytest.fixture(scope="module")
def p2_stage():
    """The JAX package's p2 deck at its stage (alpha_u = 1, alpha_t = 10,
    seeded beta_u and beta_t, t = 0.2, dt = 0.1) through JAX's
    interpret-mode B1, once for the module: (torch problem, state, torch
    TimeCoeffs, JAX residual, JAX rows, JAX stats)."""
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    pj, pt = both_problems(_jax_p2_cfg())
    pj.assembler.is_transient = True
    rng = np.random.RandomState(5)
    bu = rng.randn(pj.n_dof) * 0.05
    bt = rng.randn(pj.n_dof) * 0.05
    tj = JaxTC(jnp.asarray(1.0), jnp.asarray(bu), jnp.asarray(10.0),
               jnp.asarray(bt), jnp.asarray(0.2), jnp.asarray(0.1))
    tt = time_coeffs_from_numpy(1.0, bu, 10.0, bt, 0.2, 0.1, pt)
    u = seeded(pj.n_dof, seed=0)
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj, None, interpret=True)
    return pt, u, tt, r_j, rows_j, dict(fk.stats)


def test_p2_stage_residual_and_stats_match_jax_element_kernel(p2_stage):
    pt, u, tt, r_j, _rows_j, stats_j = p2_stage
    assert pt.assembler.is_transient
    r_t, _J = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    ft = pt.assembler.fused_provider()
    assert not ft.node and ft.nd == 27 and ft.lattice.stride == 2
    assert max_diff(r_t, r_j) < TOL_JAX
    assert ft.stats == {k: stats_j[k] for k in ft.stats}
    assert ft.stats == {"steady": False, "split": False, "n_res_rows": 27,
                        "n_jac_rows": 729, "node_scatter": False}


def test_p2_stage_rows_match_jax_element_kernel(p2_stage):
    pt, u, tt, _r_j, rows_j, _stats_j = p2_stage
    _r, J = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    assert len(J.vol_soa) == len(rows_j) == 729
    for k, (rj, rt) in enumerate(zip(rows_j, J.vol_soa)):
        assert _kind(rt) == _kind(rj), f"row {k}"
        if rj is not None:
            assert max_diff(rt, rj) < TOL_JAX, f"row {k}"


@pytest.mark.slow
def test_hex_matches_jax_element_kernel():
    """One 2x2x2 hex call, PSPG+SUPG steady, against JAX's interpret-mode
    B1 (minutes of JAX interpret time: slow)."""
    pj, pt = both_problems(ns_elem_cfg("hex", (2, 2, 2), supg=True))
    tj, tt = steady_coeffs(pj, pt)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21),
                                 TOL_JAX)
    assert ft.nd == 32 and ft.stats["n_jac_rows"] == 1024
