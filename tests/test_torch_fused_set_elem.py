"""The module-set provider (mrhyde_tpu_torch/ops/fused_set.py) on 3D hex,
through the plain version of its element-tile kernel `set_elem_full`:
NS + thermal with the Boussinesq term (PSPG steady, PSPG+SUPG at a
DIRK-2,2 stage), NS + cdr at a stage, NS whose viscosity reads ux, and
cdr whose velocity (c, 1, 0.5) reads c, each on 2x2x2 hex:

- against the JAX package's general path (residual, Jacobian blocks,
  apply, diag) and JAX's probe (row kinds, constant rows, the counts of
  `stats`), as the JAX package's own tests hold its B1 on hex (its
  interpret-mode kernel takes minutes there);
- against the port's general path, also at Newton's line-search point;
- the wrapper's plain version on CPU tensors, with its row-class check.

test_torch_fused_set_elem_p2.py holds the p2 cases (against JAX's
interpret-mode B1 where it is fast enough), the solves and the CLIs.
Tolerances: 1e-10 absolute against JAX (the same f64 weak form, other
summation orders), 1e-11 against the port's general path."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (NS_STAGE1, both_problems,  # noqa: E402
                              cdr_state_velocity_hex_cfg,
                              check_fused_against_general,
                              check_fused_against_jax_general,
                              ns_cdr_elem_cfg, ns_elem_cfg,
                              ns_thermal_elem_cfg, seeded, stage_coeffs,
                              steady_coeffs)

torch.set_num_threads(1)

TOL_JAX, TOL = 1e-10, 1e-11
TRANSIENT = {"solver": "transient"}

# name -> (deck, stage alphas or None, nd)
CASES = {
    "ns_thermal_pspg_steady": (
        lambda: ns_thermal_elem_cfg("hex", (2, 2, 2)), None, 40),
    "ns_thermal_supg_stage": (
        lambda: ns_thermal_elem_cfg("hex", (2, 2, 2), supg=True,
                                    solver=TRANSIENT), NS_STAGE1, 40),
    "ns_cdr_supg_stage": (
        lambda: ns_cdr_elem_cfg("hex", (2, 2, 2)), NS_STAGE1, 40),
    "ns_visc_ux_pspg_steady": (
        lambda: ns_elem_cfg("hex", (2, 2, 2), visc="1.0 + ux*ux"), None,
        32),
    "cdr_velocity_c_steady": (
        lambda: cdr_state_velocity_hex_cfg(2), None, 8),
}


@pytest.mark.parametrize("name", list(CASES))
def test_provider_matches_jax_and_general_path(name):
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    build, alphas, nd = CASES[name]
    pj, pt = both_problems(build())
    ft = pt.assembler.fused_provider()
    assert isinstance(ft, FusedSetAssembly) and ft.nd == nd
    assert (ft.form.dim, ft.form.nc) == (3, 8)
    tj, tt = (stage_coeffs(pj, pt, *alphas, seed=31, deltat=0.01)
              if alphas else steady_coeffs(pj, pt))
    u = seeded(pt.n_dof, seed=21)
    check_fused_against_jax_general(pj, pt, tj, tt, u, alphas, TOL_JAX)
    ut = torch.as_tensor(u)
    check_fused_against_general(pt, tt, ut, TOL)
    # Newton's line-search point
    w = ut + 0.5 * torch.as_tensor(seeded(pt.n_dof, seed=24))
    asm = pt.assembler
    assert float((asm.res_and_jac(w, tt)[0]
                  - asm.residual(w, tt)).abs().max()) < TOL


@pytest.mark.parametrize("stage", [False, True])
def test_wrapper_takes_plain_version_on_cpu_tensors(stage):
    """set_elem_full on CPU tensors is its plain version (no launch);
    a row the probe would call constant must not come back varying."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import LAUNCHES
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    cfg = ns_thermal_elem_cfg("hex", (3, 2, 2), supg=stage,
                              solver=TRANSIENT if stage else None)
    f = Problem(cfg, device="cpu").assembler.fused_provider()
    au, at = NS_STAGE1 if stage else (1.0, 0.0)
    sc = fs.SetScalars(0.3, 0.01, ())
    jac_idx = f._classify(sc, au, at, not stage)[0]
    rng = np.random.RandomState(7)
    shape = (f.nv,) + tuple(f.grid_shape)
    ue = torch.as_tensor(rng.randn(*shape))
    ud = torch.as_tensor(rng.randn(*shape)) if stage else None
    st = Stage(au, at, None) if stage else None
    args = (f.form, ue, ud, sc, f.tables, f.lattice,
            (f.origin, f.h_axes, f.q_off), jac_idx, st)
    before = dict(LAUNCHES)
    res, jac = fs.set_elem_full(*args)
    rref, jref = fs.set_elem_full_plain(*args)
    assert torch.equal(res, rref) and torch.equal(jac, jref)
    assert res.shape == (40, 12) and jac.shape == (len(jac_idx), 12)
    assert LAUNCHES == before             # plain versions launch nothing
    with pytest.raises(AssertionError):
        fs.set_elem_full_plain(*args[:7], jac_idx[1:], st)
