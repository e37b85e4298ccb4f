"""Affine module sets through mode "state": the module-set provider's
port of the JAX package's split path (`_detect_affine`, the state kernels
set_node_state / set_elem_state, the coord part) on thermal + cdr whose
coefficients read no state, on 2D p1 (B2), hex and p2 (B1), steady and at
a DIRK-2,2 stage: `stats`, residual and Jacobian rows against JAX's
kernels in Pallas interpret mode (1e-11), with boundary terms against
JAX's general path, the affine identity, and the wrappers. f64 on the
CPU; inputs from a seed."""

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (DIRK22_STAGE1, both_problems,  # noqa: E402
                              check_fused_against_general,
                              check_fused_against_jax, max_diff, seeded,
                              stage_coeffs, steady_coeffs,
                              thermal_cdr_affine_cfg, thermal_cdr_cfg)

torch.set_num_threads(1)


def _coeffs(pj, pt, stage):
    return (stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31) if stage
            else steady_coeffs(pj, pt))


@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
@pytest.mark.parametrize("stage", [False, True])
def test_affine_set_matches_jax_split(mesh, stage):
    """The port's split (state kernel plus coord part) against JAX's
    (interpret-mode B2 on 2D p1, B1 on hex and p2): `stats` equal, with
    "split": True on both sides; residual, each Jacobian row and
    apply/diag to 1e-11."""
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    pj, pt = both_problems(thermal_cdr_affine_cfg(mesh, stage, flux=False))
    assert isinstance(pt.assembler.fused_provider(), FusedSetAssembly)
    tj, tt = _coeffs(pj, pt, stage)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pt.n_dof, seed=5),
                                 1e-11)
    assert ft.stats["split"] is True and ft.stats["n_jac_rows"] == 0
    assert ft.stats["node_scatter"] is (mesh == "p1")


@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
@pytest.mark.parametrize("stage", [False, True])
def test_affine_set_with_boundary_terms_matches_general_paths(mesh, stage):
    """The same sets with a Neumann flux on e and a Flux condition on c
    (both reading t): the port's fused result with its boundary groups
    against JAX's general path (1e-11 / 1e-10 / 1e-11) and the port's
    own general path (1e-11)."""
    import jax.numpy as jnp
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(thermal_cdr_affine_cfg(mesh, stage))
    if stage:
        pj.assembler.is_transient = pt.assembler.is_transient = True
    tj, tt = _coeffs(pj, pt, stage)
    u = seeded(pt.n_dof, seed=5)
    r, J = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    assert J.bnd and pt.assembler.fused_provider().stats["split"] is True
    aj = pj.assembler
    Jj = aj.jacobian(jnp.asarray(u), tj)
    v = seeded(pt.n_dof, seed=23, scale=1.0)
    assert max_diff(r, aj.residual(jnp.asarray(u), tj)) < 1e-11
    assert max_diff(J.apply(state_from_numpy(v, pt)),
                    Jj.apply(jnp.asarray(v))) < 1e-10
    assert max_diff(J.diag(), Jj.diag()) < 1e-11
    check_fused_against_general(pt, tt, torch.as_tensor(u), 1e-11)


@pytest.mark.parametrize("mesh", ["p1", "hex", "p2"])
@pytest.mark.parametrize("stage", [False, True])
def test_state_part_plus_coord_part_is_the_one_kernel_residual(mesh, stage):
    """The affine identity: the plain state part (set_*_state) plus the
    coord part (the density at the betas) equals the plain one-kernel
    residual (set_*_full) at the combined state, to 1e-12, and the coord
    part's rows equal the one-kernel rows."""
    from mrhyde_tpu_torch.ops import fused_elem as fe
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    pj, pt = both_problems(thermal_cdr_affine_cfg(mesh, stage, flux=False))
    f = pt.assembler.fused_provider()
    _tj, tt = _coeffs(pj, pt, stage)
    u = torch.as_tensor(seeded(pt.n_dof, seed=5))
    au, at = DIRK22_STAGE1 if stage else (1.0, 0.0)
    sc = f._scalars(tt, None)
    jac_idx, consts, _n = f._classify(sc, au, at, not stage)
    jac0_idx, consts0, _n0 = f._classify(sc, au, at, not stage, "zero")
    assert jac0_idx == jac_idx
    r0, rows0 = f._coord_eval(tt, sc, not stage, au, at, jac0_idx, consts0)
    geo = (f.origin, f.h_axes, f.q_off)
    st = Stage(au, at, None) if stage else None
    grids = f._grids(u).contiguous()
    ue = f._grids(au * u + tt.beta_u).contiguous() if stage else grids
    ud = f._grids(at * u + tt.beta_t).contiguous() if stage else None
    r_state = torch.zeros_like(u)
    r_full = torch.zeros_like(u)
    if f.node:
        part = fs.set_node_state(f.form, grids, sc, f.tables, geo, st)
        whole, jac = fs.set_node_full(f.form, ue, ud, sc, f.tables, geo,
                                      jac_idx, st)
        for vi, s in enumerate(f.starts):
            r_state[s:s + part[vi].numel()] = part[vi].reshape(-1)
            r_full[s:s + whole[vi].numel()] = whole[vi].reshape(-1)
    else:
        part = fs.set_elem_state(f.form, grids, sc, f.tables, f.lattice,
                                 geo, st)
        whole, jac = fs.set_elem_full(f.form, ue, ud, sc, f.tables,
                                      f.lattice, geo, jac_idx, st)
        fe.scatter_dofs(part, r_state, f.starts, f.lattice, f.dims,
                        grids[0], f.dof2fine)
        fe.scatter_dofs(whole, r_full, f.starts, f.lattice, f.dims, ue[0],
                        f.dof2fine)
    assert max_diff(r0 + r_state, r_full) < 1e-12 * float(
        r_full.abs().max())
    from mrhyde_tpu_torch.ops.fused_ns import rows_of
    full_rows = rows_of(jac_idx, consts, jac, f.nd, u.dtype, u.device)
    for a, b in zip(rows0, full_rows):
        assert (a is None) == (b is None)
        if a is not None:
            assert max_diff(torch.broadcast_to(a, b.shape), b) < 1e-12


def test_detect_affine_follows_the_density():
    """JAX's randomized probe, ported: thermal + cdr with constant or
    coordinate-dependent coefficients is affine; a reaction or a kappa
    that reads the state is not, and takes set_*_full."""
    from mrhyde_tpu_torch.problem import Problem
    for cfg, affine in ((thermal_cdr_affine_cfg(), True),
                        (thermal_cdr_cfg("1.0 + 0.5*x", "1.0"), True),
                        (thermal_cdr_cfg("1.0", "0.5*c*c"), False),
                        (thermal_cdr_cfg("1.0 + e*c", "1.0"), False)):
        f = Problem(cfg, device="cpu", dtype=torch.float64) \
            .assembler.fused_provider()
        assert f._detect_affine(True) is affine
        assert f._detect_affine(False) is affine


@pytest.mark.parametrize("mesh", ["p1", "hex"])
def test_each_call_launches_the_state_kernel_once(mesh, monkeypatch):
    """Each res_and_jac of an affine set is one call of its state kernel
    and none of a "full" one; the coord part (plain torch) is computed
    once per stage and scalars, not per Newton iteration."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    from mrhyde_tpu_torch.ops import fused_set as fs
    calls = []
    for name in ("set_node_full", "set_elem_full", "set_node_state",
                 "set_elem_state"):
        orig = getattr(fs, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(fs, name, spy)
    pj, pt = both_problems(thermal_cdr_affine_cfg(mesh, True))
    _tj, tt = _coeffs(pj, pt, True)
    f = pt.assembler.fused_provider()
    cache = []
    for seed in (1, 2, 3):
        before = f._stage_cache
        pt.assembler.res_and_jac(
            state_from_numpy(seeded(pt.n_dof, seed=seed), pt), tt)
        cache.append(f._stage_cache is before)
    kernel = "set_node_state" if mesh == "p1" else "set_elem_state"
    assert calls == [kernel] * 3
    assert cache == [False, True, True]


@pytest.mark.parametrize("mesh", ["p1", "hex"])
def test_state_wrappers_take_plain_version_on_cpu_tensors(mesh):
    """On CPU tensors each state wrapper is its plain version, bit for
    bit, and counts no launch; another device raises rather than falls
    back."""
    from mrhyde_tpu_torch.ops import fused_set as fs
    from mrhyde_tpu_torch.ops._launch import LAUNCHES
    from mrhyde_tpu_torch.ops.fused_p1 import Stage
    from mrhyde_tpu_torch.problem import Problem
    f = Problem(thermal_cdr_affine_cfg(mesh), device="cpu",
                dtype=torch.float64).assembler.fused_provider()
    g = torch.Generator().manual_seed(3)
    u = torch.rand((f.nv,) + tuple(f.grid_shape), generator=g,
                   dtype=torch.float64)
    sc = fs.SetScalars(0.1, 0.05, ())
    geo = (f.origin, f.h_axes, f.q_off)
    st = Stage(*DIRK22_STAGE1, None)
    if mesh == "p1":
        args = (f.form, u, sc, f.tables, geo, st)
        wrap, plain = fs.set_node_state, fs.set_node_state_plain
    else:
        args = (f.form, u, sc, f.tables, f.lattice, geo, st)
        wrap, plain = fs.set_elem_state, fs.set_elem_state_plain
    before = dict(LAUNCHES)
    assert torch.equal(wrap(*args), plain(*args))
    assert LAUNCHES == before
    with pytest.raises(ValueError):
        wrap(*((args[0], u.to("meta")) + args[2:]))
