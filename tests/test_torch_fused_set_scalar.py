"""The module-set provider (mrhyde_tpu_torch/ops/fused_set.py) on thermal
+ cdr and on a cdr velocity that reads the state, against the JAX
package's node-scatter kernel B2 in Pallas interpret mode (1e-10, its
`stats`) and the port's general path (1e-11). A thermal + cdr set whose
density is affine takes JAX's split path in both packages: the same
residual, rows and `stats`. And the wrapper: the plain version on CPU
tensors, raising on other devices."""

import jax
import jax.numpy as jnp
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (DIRK22_STAGE1, both_problems,  # noqa: E402
                              cdr_state_velocity_cfg,
                              check_fused_against_general,
                              check_fused_against_jax, max_diff, seeded,
                              stage_coeffs, steady_coeffs, thermal_cdr_cfg)

torch.set_num_threads(1)


CASES = {
    "thermal_cdr_kappa_ec_steady": (
        lambda: thermal_cdr_cfg("1.0 + e*c"), False),
    "thermal_cdr_kappa_ec_stage": (
        lambda: thermal_cdr_cfg("1.0 + e*c", transient=True), True),
    "cdr_velocity_c_stage": (cdr_state_velocity_cfg, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_provider_matches_jax_node_kernel(name):
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    build, stage = CASES[name]
    pj, pt = both_problems(build())
    assert isinstance(pt.assembler.fused_provider(), FusedSetAssembly)
    tj, tt = (stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31) if stage
              else steady_coeffs(pj, pt))
    u = seeded(pt.n_dof, seed=5)
    check_fused_against_jax(pj, pt, tj, tt, u, 1e-10)
    check_fused_against_general(pt, tt, torch.as_tensor(u), 1e-11)


def test_affine_set_same_numbers_as_jax_split():
    """thermal + cdr with coefficients that read no state: JAX's affine
    split and the port's (set_node_state plus the coord part; both
    `stats` say so) give the same residual and Jacobian rows."""
    from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(thermal_cdr_cfg("1.0 + 0.5*x", reaction="1.0"))
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pt.n_dof, seed=5)
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj, None, interpret=True)
    assert fk.stats["split"] is True
    ft = pt.assembler.fused_provider()
    r_t, rows_t = ft.res_jac(state_from_numpy(u, pt), tt)
    assert ft.stats["split"] is True
    assert max_diff(torch.where(pt.assembler.fixed, 0.0, r_t), r_j) < 1e-10
    for k, (rj, rt) in enumerate(zip(rows_j, rows_t)):
        assert (rj is None) == (rt is None), k
        if rj is not None:
            assert max_diff(torch.broadcast_to(rt, (16,)),
                            jnp.broadcast_to(rj, (16,))) < 1e-10, k


@pytest.mark.parametrize("stage", [False, True])
def test_wrapper_takes_plain_version_on_cpu_tensors(stage):
    """On CPU tensors the wrapper is its plain version, bit for bit, and
    counts no launch; another device raises rather than falls back."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import LAUNCHES
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    cfg = thermal_cdr_cfg("1.0 + e*c", transient=stage)
    fused = Problem(cfg, device="cpu", dtype=torch.float64) \
        .assembler.fused_provider()
    g = torch.Generator().manual_seed(3)
    ue = torch.rand((2, 5, 5), generator=g, dtype=torch.float64)
    ud = torch.rand((2, 5, 5), generator=g, dtype=torch.float64) \
        if stage else None
    st = Stage(*DIRK22_STAGE1, None) if stage else None
    sc = fs.SetScalars(0.1, 0.05, ())
    au, at = DIRK22_STAGE1 if stage else (1.0, 0.0)
    jac_idx = fused._classify(sc, au, at, not stage)[0]
    geo = (fused.origin, fused.h_axes, fused.q_off)
    before = dict(LAUNCHES)
    args = (fused.form, ue, ud, sc, fused.tables, geo, jac_idx, st)
    out, plain = fs.set_node_full(*args), fs.set_node_full_plain(*args)
    assert LAUNCHES == before
    assert all(torch.equal(a, b) for a, b in zip(out, plain))
    assert out[0].shape == (2, 5, 5) and out[1].shape == (len(jac_idx), 16)
    with pytest.raises(ValueError):
        fs.set_node_full(fused.form, ue.to("meta"), None, sc, fused.tables,
                         geo, jac_idx)
