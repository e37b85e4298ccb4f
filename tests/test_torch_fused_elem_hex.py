"""The port's thermal provider on 3D uniform hex (p1), through the plain
versions of its element kernels (mrhyde_tpu_torch/ops/fused_elem.py),
against the JAX package's FusedP1Assembly.res_jac in Pallas interpret
mode, which runs the element-tile TPU kernel B1 on the CPU: residual,
the kind of each Jacobian row (None / element-independent scalar / (E,)
array) and its value, `stats`, and the BlockJacobian's apply and diag;
steady calls and a DIRK-2,2 stage (seeded beta_u, beta_t handed to both
packages). Then the same provider inside Assembler.res_and_jac against
the port's general path, and the reference's thermal/3D_verification
deck end to end.

Tolerance 1e-11 absolute: the same f64 weak form summed in the same
quadrature and corner order (the scatter and the coord part in another
order of the same terms), on O(1) entries."""

import numpy as np
import pytest
import torch

from mrhyde_tpu_torch.ops import fused_elem as fe
from mrhyde_tpu_torch.ops import fused_p1 as fp
from torch_port_utils import (DIRK22_STAGE1, KAPPAS3, MASSES, SOURCE3_NL,
                              as_transient, both_problems,
                              check_fused_against_general,
                              check_fused_against_jax, hex_cfg, seeded,
                              stage_coeffs, steady_coeffs)

torch.set_num_threads(1)

TOL = 1e-11


def _hex_cfg(n, kappa):
    if kappa == "1.0 + e*e":
        return hex_cfg(*n, kappa=kappa, source=SOURCE3_NL)
    return hex_cfg(*n, kappa=kappa)


@pytest.mark.parametrize("n", [(3, 3, 3), (3, 2, 2)])
@pytest.mark.parametrize("kappa", KAPPAS3)
def test_hex_provider_matches_jax_element_kernel(kappa, n):
    pj, pt = both_problems(_hex_cfg(n, kappa))
    tj, tt = steady_coeffs(pj, pt)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21),
                                 TOL)
    assert not ft.node and ft.nc == 8


@pytest.mark.parametrize("kappa", ["1.0 + 0.5*x*y*z", "1.0 + e*e"])
def test_hex_stage_matches_jax_element_kernel(kappa):
    """A DIRK-2,2 stage-1 call (alpha_u = 0.5, beta_u != 0) with a
    coordinate-dependent rho cp: the split (coord part with the state
    kernel on the beta grids) and mode "full"."""
    pj, pt = both_problems(as_transient(_hex_cfg((3, 2, 2), kappa),
                                        MASSES[1]))
    tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31)
    check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21), TOL)


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("kappa", KAPPAS3)
def test_hex_res_and_jac_engages_fused_and_matches_general(kappa, stage):
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    cfg = _hex_cfg((3, 4, 2), kappa)
    if stage:
        cfg = as_transient(cfg, MASSES[1])
    pt = Problem(cfg, device="cpu")
    n = pt.n_dof
    tt = (time_coeffs_from_numpy(DIRK22_STAGE1[0], seeded(n, seed=31),
                                 DIRK22_STAGE1[1],
                                 seeded(n, seed=32, scale=5.0), 0.3, 0.05, pt)
          if stage else TimeCoeffs.steady(n))
    check_fused_against_general(pt, tt, torch.as_tensor(seeded(n, seed=22)),
                                TOL)


def test_hex_gold_through_the_fused_provider():
    """thermal/3D_verification (10^3 hex, direct): the reference's gold
    L2(e) = 0.0116656 with every assembly through the fused provider."""
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(hex_cfg(10, 10, 10), device="cpu")
    fused = p.assembler.fused_provider()
    assert fused is not None and not fused.node
    calls = []
    jacobian = fused.jacobian

    def counted(*a, **k):
        calls.append(1)
        return jacobian(*a, **k)
    fused.jacobian = counted
    res = p.run()
    assert res.errors[("L2", "e")] == pytest.approx(0.0116656, rel=2e-5)
    assert len(calls) >= 1


def test_transient_coord_part_runs_elem_state_on_betas(monkeypatch):
    """Under the split a stage's first call runs the element state kernel
    on the beta_u grid (alpha = (1, 0)) and the beta_t grid (alpha = (0,
    1)), then on u; later calls of the stage on u alone."""
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(as_transient(_hex_cfg((2, 3, 2), "1.0 + 0.5*x*y*z"),
                              MASSES[1]), device="cpu")
    asm = pt.assembler
    ft = asm.fused_provider()
    seen = []
    state = fe.thermal_elem_state

    def recorded(grid, kappa, tab, lat, stage=None, vel=None):
        seen.append((grid.clone(), None if stage is None
                     else (stage.alpha_u, stage.alpha_t)))
        return state(grid, kappa, tab, lat, stage, vel)
    monkeypatch.setattr(fe, "thermal_elem_state", recorded)
    n = pt.n_dof
    tt = time_coeffs_from_numpy(DIRK22_STAGE1[0], seeded(n, seed=41),
                                DIRK22_STAGE1[1], seeded(n, seed=42), 0.3,
                                0.05, pt)
    ut = torch.as_tensor(seeded(n, seed=25))
    asm.res_and_jac(ut, tt)
    assert [s for _, s in seen] == [(1.0, 0.0), (0.0, 1.0), DIRK22_STAGE1]
    for (g, _), v in zip(seen, (tt.beta_u, tt.beta_t, ut)):
        assert torch.equal(g, ft._grid(v))
    asm.res_and_jac(ut + 0.1, tt)
    assert len(seen) == 4 and seen[3][1] == DIRK22_STAGE1


def _hex_tables():
    from mrhyde_tpu_torch.problem import Problem
    f = Problem(hex_cfg(2, 2, 2), device="cpu").assembler.fused_provider()
    return f.tables, f.lattice


def test_elem_wrappers_take_plain_versions_on_cpu_tensors():
    tab, lat = _hex_tables()
    rng = np.random.RandomState(31)
    grid = torch.as_tensor(rng.randn(4, 3, 5))
    E = 3 * 2 * 4
    qp = [torch.as_tensor(rng.randn(E, tab.Q)) for _ in range(5)]
    before = dict(fp.LAUNCHES)
    for stage in (None, fp.Stage(0.5, 40.0, qp[4]), fp.Stage(0.0, 20.0, 2.0)):
        for kappa in (1.5, qp[2]):
            rows = fe.thermal_elem_state(grid, kappa, tab, lat, stage)
            assert rows.shape == (8, E)
            assert torch.equal(rows, fe.thermal_elem_state_plain(
                grid, kappa, tab, lat, stage))
        res, jac = fe.thermal_elem_full(grid, *qp[:4], tab, lat, stage)
        ref, jref = fe.thermal_elem_full_plain(grid, *qp[:4], tab, lat, stage)
        assert res.shape == (8, E) and jac.shape == (64, E)
        assert torch.equal(res, ref) and torch.equal(jac, jref)
    assert fp.LAUNCHES == before          # plain versions launch nothing


def test_elem_rows_are_the_element_integrals():
    """The state rows of one element are its stiffness matrix times its
    corner values, whatever the grid around it."""
    tab, lat = _hex_tables()
    rng = np.random.RandomState(5)
    grid = torch.as_tensor(rng.randn(2, 2, 2))
    rows = fe.thermal_elem_state_plain(grid, 1.0, tab, lat)
    uc = torch.stack(fe.corner_values(grid, lat))[:, 0]
    grad = torch.as_tensor(np.asarray(tab.grad))
    K = torch.einsum("cqd,pqd,q->cp", grad, grad,
                     torch.as_tensor(np.asarray(tab.wts)))
    assert float((rows[:, 0] - K @ uc).abs().max()) < 1e-14


def test_elem_wrappers_refuse_other_devices():
    tab, lat = _hex_tables()
    with pytest.raises(ValueError):
        fe.thermal_elem_state(torch.zeros(3, 3, 3, device="meta"), 1.0, tab,
                              lat)
