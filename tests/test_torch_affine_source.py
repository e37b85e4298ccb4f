"""A single thermal or cdr module whose source is affine in its own
variable (a thermal source e + x y, a cdr reaction 2 c or (1 + x) c)
takes the affine split in mrhyde_tpu_torch (`ops/fused_p1.py`, mode
"state": the state kernel with the linear part on its mass lane, the
coord part plain torch once per stage), as the JAX package's
`_detect_affine` decides; a conductivity that reads the variable (kappa
= e) is not affine and takes mode "full" in both. On the CPU in f64 the
provider's residual, Jacobian rows and `stats` equal JAX's
interpret-mode kernel B2 (2D p1) or JAX's general path (hex and p2, B1),
steady and at a DIRK-2,2 stage, and the decks' solves give JAX's L2."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (DIRK22_STAGE1, S_TRUE,  # noqa: E402
                              both_problems, cdr_cfg,
                              check_fused_against_jax, max_diff, seeded,
                              solve_both, stage_coeffs, steady_coeffs,
                              thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-11

DECKS = {
    # -div grad e = 8 pi^2 S + e - S: a source linear in e
    "thermal_source_e": (lambda n: thermal_cfg(
        n, source=f"e + 8*(pi*pi)*{S_TRUE} - {S_TRUE}"), True),
    "cdr_reaction_2c": (lambda n: cdr_cfg(n, reaction="2.0*c"), True),
    "cdr_reaction_x_c": (lambda n: cdr_cfg(n, reaction="(1.0 + x)*c"),
                         True),
    "thermal_kappa_e": (lambda n: thermal_cfg(n, kappa="e"), False),
}


@pytest.mark.parametrize("stage", [False, True], ids=["steady", "stage"])
@pytest.mark.parametrize("name", list(DECKS))
def test_affine_source_takes_the_split_as_jax(name, stage):
    """The provider's residual, each Jacobian row's kind and value and
    `stats` against JAX's interpret-mode kernel at a seeded state (and
    seeded betas at a stage); split iff JAX's _detect_affine says so."""
    build, affine = DECKS[name]
    pj, pt = both_problems(build(5))
    if stage:
        pj.assembler.is_transient = pt.assembler.is_transient = True
        tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=5)
    else:
        tj, tt = steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=3, scale=1.0)
    ft = check_fused_against_jax(pj, pt, tj, tt, u, TOL)
    assert ft.split is affine and ft.stats["split"] is affine
    if affine:
        assert ft.stats["n_jac_rows"] == 0


@pytest.mark.parametrize("mesh", ["hex", "p2"])
def test_affine_reaction_on_the_element_kernels(mesh):
    """cdr with reaction 2 c on hex and p2 quads: thermal_elem_state's
    split (JAX's _detect_affine says affine), its residual, Jacobian
    blocks, apply and diag against JAX's general path, steady and at a
    stage."""
    import jax.numpy as jnp
    from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
    from mrhyde_tpu_torch.interop import state_from_numpy
    cfg = (cdr_cfg(3, 2, 2, reaction="2.0*c") if mesh == "hex"
           else cdr_cfg(3, reaction="2.0*c", order=2))
    pj, pt = both_problems(cfg)
    assert JaxFused.build(pj.assembler)._detect_affine(True, jnp.float64,
                                                       ())
    u = seeded(pj.n_dof, seed=9, scale=1.0)
    for stage in (False, True):
        if stage:
            pj.assembler.is_transient = pt.assembler.is_transient = True
            tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=5)
        else:
            tj, tt = steady_coeffs(pj, pt)
        asm, aj = pt.assembler, pj.assembler
        r, J = asm.res_and_jac(state_from_numpy(u, pt), tt)
        ft = asm.fused_provider()
        assert ft.split and not ft.node and ft.stats["split"]
        uj = jnp.asarray(u)
        Jj = aj.jacobian(uj, tj)
        assert max_diff(r, aj.residual(uj, tj)) < TOL
        assert max_diff(J.aos(), Jj.vol) < TOL
        v = seeded(pt.n_dof, seed=23, scale=1.0)
        assert max_diff(J.apply(state_from_numpy(v, pt)),
                        Jj.apply(jnp.asarray(v))) < TOL
        assert max_diff(J.diag(), Jj.diag()) < TOL


@pytest.mark.parametrize("name", ["thermal_source_e", "cdr_reaction_2c"])
def test_affine_source_deck_solves_to_jax(name):
    """The affine decks' steady solves at 16^2 give the JAX package's
    solution and L2 to 1e-11, on the split path."""
    build, _affine = DECKS[name]
    _rj, _rt, pt = solve_both(build(16))
    assert pt.assembler.fused_provider().split


def test_affine_reaction_transient_solves_to_jax():
    """cdr with reaction 2 c, a BWE start-up from 0 (the coord part's
    beta grids through the state kernel on its mass lane): JAX's
    history to 1e-11."""
    cfg = cdr_cfg(8, reaction="2.0*c", transient=True)
    _rj, _rt, pt = solve_both(cfg)
    assert pt.assembler.fused_provider().split
    assert np.isfinite(_rt.u.numpy()).all()
