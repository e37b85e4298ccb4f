"""The module-set provider (mrhyde_tpu_torch/ops/fused_set.py) on 2D p2
quads, through the plain version of its element-tile kernel
`set_elem_full` (nc = 9 on the fine lattice, residual rows scattered
through `dof2fine`):

- thermal + cdr with kappa = 1 + e c against the JAX package's
  interpret-mode element-tile kernel B1 (`FusedP1Assembly.res_jac`) on
  2x2 p2: residual, every row's kind and value, `stats` (34 s of JAX
  interpret time);
- NS + thermal with the Boussinesq term, PSPG steady and PSPG+SUPG at a
  DIRK-2,2 stage, against JAX's general path and JAX's probe, and the
  same stage against JAX's interpret-mode B1 (marked slow: 150 s of JAX
  interpret time);
- each against the port's general path.

Tolerances: 1e-10 absolute against JAX (the same f64 weak form, other
summation orders), 1e-11 against the port's general path."""

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (NS_STAGE1, both_problems,  # noqa: E402
                              check_fused_against_general,
                              check_fused_against_jax,
                              check_fused_against_jax_general,
                              ns_thermal_elem_cfg, seeded, stage_coeffs,
                              steady_coeffs, thermal_cdr_p2_cfg)

torch.set_num_threads(1)

TOL_JAX, TOL = 1e-10, 1e-11
TRANSIENT = {"solver": "transient"}


def _problems(cfg, nd):
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    pj, pt = both_problems(cfg)
    ft = pt.assembler.fused_provider()
    assert isinstance(ft, FusedSetAssembly) and ft.nd == nd
    assert (ft.form.dim, ft.form.nc) == (2, 9) and ft.dof2fine is not None
    return pj, pt


def test_thermal_cdr_matches_jax_interpret_kernel():
    pj, pt = _problems(thermal_cdr_p2_cfg(2), 18)
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pt.n_dof, seed=21)
    ft = check_fused_against_jax(pj, pt, tj, tt, u, TOL_JAX)
    assert ft.stats["split"] is False and ft.stats["node_scatter"] is False
    assert ft.stats["n_jac_rows"] == 243       # no c-row reads e
    check_fused_against_general(pt, tt, torch.as_tensor(u), TOL)


@pytest.mark.parametrize("stage", [False, True])
def test_ns_thermal_matches_jax_general_path(stage):
    cfg = ns_thermal_elem_cfg("p2", (2, 2), supg=stage,
                              solver=TRANSIENT if stage else None)
    pj, pt = _problems(cfg, 36)
    tj, tt = (stage_coeffs(pj, pt, *NS_STAGE1, seed=31, deltat=0.01)
              if stage else steady_coeffs(pj, pt))
    u = seeded(pt.n_dof, seed=21)
    check_fused_against_jax_general(pj, pt, tj, tt, u,
                                    NS_STAGE1 if stage else None, TOL_JAX)
    check_fused_against_general(pt, tt, torch.as_tensor(u), TOL)


@pytest.mark.slow
def test_ns_thermal_stage_matches_jax_interpret_kernel():
    cfg = ns_thermal_elem_cfg("p2", (2, 2), supg=True, solver=TRANSIENT)
    pj, pt = _problems(cfg, 36)
    tj, tt = stage_coeffs(pj, pt, *NS_STAGE1, seed=31, deltat=0.01)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pt.n_dof, seed=21),
                                 TOL_JAX)
    assert ft.stats["steady"] is False and ft.stats["split"] is False
