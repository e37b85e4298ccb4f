"""Element blocks of internal meshes (Panzer's eblock-i_j labels) and
per-block physics in mrhyde_tpu_torch against the JAX package on the CPU
in f64: the reference's thermal/2D_multiblock gold and its per-block
norms, the route of a multi-block deck with one physics list (the fused
node kernel, as JAX's), JAX's two-block thermal + cdr deck
(tests/test_per_block_physics.py) with its blockwise masked residual and
its boundary groups, and per-block Functions, which both packages
refuse."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (both_problems,  # noqa: E402
                              check_fused_against_jax, multiblock_cfg,
                              per_block_cfg, seeded, steady_coeffs)

torch.set_num_threads(1)

MULTIBLOCK_GOLD = 0.000513878
BLOCK_KEYS = [("L2", "e"), ("L2@1", "e"), ("L2@2", "e"), ("L2@3", "e")]


def _solve_both(cfg, rtol=1e-11):
    """Both packages' runs of cfg, their solutions within rtol of each
    other (relative to max |u|) and every norm within rtol; returns the
    port's result."""
    pj, pt = both_problems(cfg)
    rj, rt = pj.run(), pt.run()
    uj = np.asarray(rj.u)
    assert np.max(np.abs(rt.u.numpy() - uj)) <= rtol * np.max(np.abs(uj))
    assert set(rt.errors) == set(rj.errors)
    for key, val in rj.errors.items():
        assert abs(rt.errors[key] - val) <= rtol * abs(val), key
    return rt


def test_multiblock_gold_and_per_block_norms():
    """thermal/2D_multiblock: 2x2 blocks of 10x10 elements, one L2 norm
    per block, each the gold 0.000513878 (the reference's file repeats
    the line per block), and JAX's to 1e-11."""
    rt = _solve_both(multiblock_cfg(10))
    for key in BLOCK_KEYS:
        assert np.isclose(rt.errors[key], MULTIBLOCK_GOLD, rtol=2e-5), key
    assert rt.report().count("L2 norm of the error for e") == 4


def test_block_labels_match_jax():
    """The eblock-i_j(_k) labels and block ids of 2D and 3D internal
    meshes, as the JAX package assigns them."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.problem import Problem
    for mesh in ({"dimension": 2, "element type": "quad", "NX": 3,
                  "NY": 2, "Xblocks": 3, "Yblocks": 2},
                 {"dimension": 3, "element type": "hex", "NX": 2, "NY": 2,
                  "NZ": 1, "Xblocks": 2, "Yblocks": 1, "Zblocks": 3}):
        mj = JaxProblem._internal_mesh(mesh, mesh["element type"])
        mt = Problem._internal_mesh(mesh, mesh["element type"])
        assert mt.block_names == mj.block_names
        assert np.array_equal(mt.block_ids, mj.block_ids)
        assert np.array_equal(mt.conn, mj.conn)


@pytest.mark.parametrize("mesh", ["quad", "hex"])
def test_single_physics_multiblock_keeps_the_fused_route(mesh):
    """One physics list over several blocks: block ids leave the
    structured plan and the uniform geometry alone, so the port's fused
    provider takes the deck (B2 thermal_node_state on 2D p1, B1 on hex),
    with JAX's interpret-mode kernel's residual, rows and stats."""
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    cfg = multiblock_cfg(4)
    if mesh == "hex":
        cfg["Mesh"].update({"dimension": 3, "element type": "hex",
                            "NZ": 2, "Zblocks": 1})
        cfg["Functions"]["thermal source"] = \
            "3*(pi*pi)*sin(pi*x)*sin(pi*y)*sin(pi*z)"
        cfg["Physics"]["Dirichlet conditions"] = {
            "e": {"all boundaries": 0.0}}
        cfg["Postprocess"]["True solutions"] = {
            "e": "sin(pi*x)*sin(pi*y)*sin(pi*z)"}
    pj, pt = both_problems(cfg)
    assert pt.assembler._structured is not None and pt.assembler.uniform
    assert isinstance(pt.assembler.fused_provider(), FusedP1Assembly)
    assert pt.assembler.fused_provider().node == (mesh == "quad")
    tj, tt = steady_coeffs(pj, pt)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pt.n_dof, seed=7),
                                 1e-11)
    assert ft.stats["split"] is True


def test_two_block_thermal_cdr():
    """JAX's two-block deck (thermal on eblock-0_0, cdr on eblock-1_0):
    module masks (E, 2), the general path, and every per-block norm and
    the solution as JAX's; each field's own block error as small as
    JAX's test asks."""
    pj, pt = both_problems(per_block_cfg(16))
    asm = pt.assembler
    assert asm.module_masks is not None and asm.module_masks.shape[1] == 2
    assert np.array_equal(asm.module_masks.numpy(),
                          np.asarray(pj.assembler.module_masks))
    assert asm.fused_provider() is None
    rt = _solve_both(per_block_cfg(16))
    assert rt.errors[("L2", "e")] < 0.02
    assert rt.errors[("L2@1", "c")] < 0.02
    assert np.isfinite(rt.errors[("L2@1", "e")])


@pytest.mark.parametrize("neumann", [False, True])
def test_masked_residual_and_jacobian_match_jax(neumann):
    """The blockwise masked residual and Jacobian at a seeded state
    (with the Neumann deck, the masked boundary groups too) against
    JAX's general path; the thermal rows of dofs strictly inside the cdr
    block are zero, as JAX's test checks."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(per_block_cfg(8, neumann=neumann))
    assert bool(pt.assembler._active_bnd_groups()) == neumann
    tj, tt = steady_coeffs(pj, pt)
    u = np.random.RandomState(0).randn(pt.n_dof)
    rj = np.asarray(pj.assembler.residual(jnp.asarray(u), tj))
    rt = pt.assembler.residual(state_from_numpy(u, pt), tt).numpy()
    assert np.max(np.abs(rt - rj)) <= 1e-12 * np.max(np.abs(rj))
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(state_from_numpy(u, pt), tt)
    assert np.max(np.abs(Jt.vol.numpy() - np.asarray(Jj.vol))) <= 1e-12
    for bt, bj in zip(Jt.bnd, Jj.bnd, strict=True):
        assert np.max(np.abs(bt.numpy() - np.asarray(bj))) <= 1e-12
    dm = pt.assembler.disc.dofmap
    i_e = dm.var_index("e")
    inside = np.nonzero(dm.vars[i_e].dof_coords[:, 0] > 1.0 + 1e-9)[0]
    assert np.abs(rt[int(dm.var_start[i_e]) + inside]).max() < 1e-12


def test_per_block_boundary_groups_solve():
    """Thermal's top Neumann flux on its own block only: the solve, its
    per-block norms and the error JAX's test bounds."""
    rt = _solve_both(per_block_cfg(16, neumann=True))
    assert rt.errors[("L2", "e")] < 0.03
    assert rt.errors[("L2@1", "c")] < 0.02


def test_per_block_functions_defined_differently_raise_in_both():
    """Per-block Functions that define a name differently: the JAX
    package refuses them in one physics set, and so does the port, with
    the same message."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.problem import Problem
    cfg = multiblock_cfg(2, blocks=(2, 1))
    cfg["Functions"] = {"eblock-0_0": {"thermal source": "1.0"},
                        "eblock-1_0": {"thermal source": "2.0"}}
    with pytest.raises(NotImplementedError) as ej:
        JaxProblem(cfg)
    with pytest.raises(NotImplementedError) as et:
        Problem(cfg, device="cpu")
    assert str(et.value) == str(ej.value)
    assert "not supported in one physics set" in str(et.value)
