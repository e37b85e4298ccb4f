"""The port's thermal provider on 2D p2 quads, through the plain versions
of its element kernels (mrhyde_tpu_torch/ops/fused_elem.py) on the p2
fine lattice, against the JAX package's FusedP1Assembly.res_jac in
Pallas interpret mode, which runs the element-tile TPU kernel B1 on its
parity-class grids on the CPU: residual, the kind of each Jacobian row
and its value, `stats`, and the BlockJacobian's apply and diag; steady
calls and a DIRK-2,2 stage (seeded beta_u, beta_t handed to both
packages). Then the provider inside Assembler.res_and_jac against the
port's general path (which reads p2 through lids), and a p2 forward
solve against the JAX package's Problem.run().

Tolerances: 1e-11 absolute for the assembly (the same f64 weak form,
the scatter in another order of the same terms); rtol 1e-9 on L2 and
1e-10 on the state against JAX's live f64 solve (same discretization
and direct solver, different summation order)."""

import numpy as np
import pytest
import torch

from mrhyde_tpu_torch.interop import state_to_numpy
from torch_port_utils import (DIRK22_STAGE1, KAPPAS, MASSES, SOURCE_NL,
                              as_transient, both_problems,
                              check_fused_against_general,
                              check_fused_against_jax, p2_cfg, seeded,
                              stage_coeffs, steady_coeffs)

torch.set_num_threads(1)

TOL = 1e-11


def _p2_cfg(n, kappa, solver=None):
    if kappa == "1.0 + e*e":
        return p2_cfg(*n, kappa=kappa, source=SOURCE_NL, solver=solver)
    return p2_cfg(*n, kappa=kappa, solver=solver)


@pytest.mark.parametrize("kappa", KAPPAS)
def test_p2_provider_matches_jax_element_kernel(kappa):
    pj, pt = both_problems(_p2_cfg((4, 3), kappa))
    tj, tt = steady_coeffs(pj, pt)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21),
                                 TOL)
    assert not ft.node and ft.nc == 9 and ft.lattice.stride == 2


def test_p2_stage_matches_jax_element_kernel():
    """A DIRK-2,2 stage-1 call (alpha_u = 0.5, beta_u != 0) with kappa = 1
    + 0.5 x y and a coordinate-dependent rho cp: the split, the coord part
    with the state kernel on the beta grids gathered through the fine
    lattice."""
    pj, pt = both_problems(as_transient(_p2_cfg((4, 3), "1.0 + 0.5*x*y"),
                                        MASSES[1]))
    tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31)
    check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21), TOL)


@pytest.mark.parametrize("stage", [False, True])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_p2_res_and_jac_engages_fused_and_matches_general(kappa, stage):
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    cfg = _p2_cfg((5, 3), kappa)
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


def test_p2_structured_plan_keeps_the_general_path_on_lids():
    """A p2 deck has a structured plan (for the fused provider) that the
    general gather/scatter does not read: it goes through lids."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    asm = Problem(_p2_cfg((3, 2), "1.0"), device="cpu").assembler
    assert asm._structured["plan"][0][0] == "p2"
    assert not asm._structured["general"] and not asm._slices
    J = asm.jacobian(torch.zeros(asm.n_dof), TimeCoeffs.steady(asm.n_dof))
    assert asm.matfree_apply_fn(J) == J.apply


def test_p2_fine_lattice_maps_are_inverse():
    from mrhyde_tpu_torch.problem import Problem
    f = Problem(_p2_cfg((4, 3), "1.0"), device="cpu").assembler \
        .fused_provider()
    assert f.grid_shape == (9, 7)
    n = f.fine_idx.numel()
    ids = torch.arange(n) + f.start
    assert torch.equal(f.fine_idx.reshape(-1)[f.dof2fine], ids)
    v = torch.as_tensor(seeded(n, seed=3))
    assert torch.equal(f._grid(v).reshape(-1)[f.dof2fine], v)


def test_p2_forward_solve_matches_jax():
    """kappa = 1 + e*e with its manufactured source at 8x8, p2, direct:
    the port's Newton solve through the fused provider against the JAX
    package's Problem.run() (its general path)."""
    cfg = _p2_cfg((8, 8), "1.0 + e*e", solver={"nonlinear TOL": 1e-12})
    pj, pt = both_problems(cfg)
    assert pt.assembler.fused_provider() is not None
    rt = pt.run()
    rj = pj.run()
    l2 = rt.errors[("L2", "e")]
    assert rt.newton.converged
    assert l2 == pytest.approx(rj.errors[("L2", "e")], rel=1e-9)
    assert np.max(np.abs(state_to_numpy(rt.u) - np.asarray(rj.u))) < 1e-10
