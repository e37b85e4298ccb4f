"""The module-set provider (mrhyde_tpu_torch/ops/fused_set.py) on NS +
thermal with the Boussinesq term, against the JAX package's node-scatter
kernel B2 (`FusedP1Assembly.res_jac` in Pallas interpret mode) and
against the port's general path: with and without thermal advection by
(ux, uy), steady and at a PSPG+SUPG DIRK-2,2 stage. The provider runs
its plain version here (CPU tensors), the one the card's generated
kernel is held to. f64: 1e-10 absolute against JAX's kernel, 1e-11
against the general path; `stats` equal JAX's (test_torch_fused_set_ns.py
and _scalar.py: the other sets)."""

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (NS_STAGE1, both_problems,  # noqa: E402
                              check_fused_against_general,
                              check_fused_against_jax, ns_cdr_cfg,
                              ns_thermal_cfg, seeded, stage_coeffs,
                              steady_coeffs)

torch.set_num_threads(1)


CASES = {
    # name: (deck, stage?, JAX's element-varying Jacobian rows of 256)
    "ns_thermal_pspg_steady": (lambda: ns_thermal_cfg(), False, None),
    "boussinesq_advected_pspg_steady": (
        lambda: ns_thermal_cfg(True, beta=1.0, t_amb=0.0, src="-1.0",
                               kappa="1.0"), False, 176),
    "ns_thermal_advected_supg_stage": (
        lambda: ns_thermal_cfg(advect=True, supg=True, transient=True),
        True, None),
}


@pytest.mark.parametrize("name", list(CASES))
def test_provider_matches_jax_node_kernel(name):
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    build, stage, n_rows = CASES[name]
    pj, pt = both_problems(build())
    assert isinstance(pt.assembler.fused_provider(), FusedSetAssembly)
    tj, tt = (stage_coeffs(pj, pt, *NS_STAGE1, seed=31, deltat=0.01)
              if stage else steady_coeffs(pj, pt))
    u = seeded(pt.n_dof, seed=5)
    ft = check_fused_against_jax(pj, pt, tj, tt, u, 1e-10)
    assert ft.stats["split"] is False and ft.stats["node_scatter"] is True
    assert ft.stats["steady"] is (not stage)
    if n_rows is not None:
        assert ft.stats["n_jac_rows"] == n_rows
    check_fused_against_general(pt, tt, torch.as_tensor(u), 1e-11)


def test_buoyancy_only_with_a_temperature():
    """JAX's `"e" in q._u`: NS + cdr has no Boussinesq term (its
    variable is c), NS + thermal has one, which beta scales."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    res = {}
    for beta in (0.0, 2.5):
        cfg = ns_thermal_cfg()
        cfg["Physics"]["beta"] = beta
        p = Problem(cfg, device="cpu", dtype=torch.float64)
        u = torch.as_tensor(seeded(p.n_dof, seed=9))
        res[beta] = p.assembler.res_and_jac(
            u, TimeCoeffs.steady(p.n_dof))[0]
    uy = torch.as_tensor(p.disc.dofmap.all_dofs("uy"))
    assert float((res[2.5] - res[0.0])[uy].abs().max()) > 1e-3
    form = Problem(ns_cdr_cfg(), device="cpu").assembler.fused_provider() \
        .form
    assert "buoy" not in form.source and "T(a.sc[1])" not in form.source
