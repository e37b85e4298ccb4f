"""Boundary terms (Neumann, Flux, weak Dirichlet) on the port's fused
providers against the JAX package's general path: the boundary groups'
residual and blocks, attached to each provider's volume result by
Assembler.res_and_jac as the JAX package attaches them, and the deck
keys that select them. f64 on the CPU; inputs from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (DIRK22_STAGE1, NS_STAGE1,  # noqa: E402
                              both_problems, cdr_cfg, channel_cfg,
                              hex_cfg, max_diff, p2_cfg, seeded,
                              stage_coeffs, steady_coeffs, thermal_cfg)

torch.set_num_threads(1)


def neumann_cfg():
    """The JAX package's tests/test_fused_p1.py::
    test_fused_composes_with_boundary_groups deck: 5x4 thermal, kappa = 1
    + 0.5 x, e = 0 on the left and bottom, Neumann fluxes on the right
    and top."""
    return {
        "Mesh": {"dimension": 2, "element type": "quad", "NX": 5, "NY": 4},
        "Functions": {"thermal source": "sin(pi*x)*y",
                      "thermal diffusion": "1.0 + 0.5*x"},
        "Physics": {"modules": "thermal",
                    "Dirichlet conditions": {
                        "scalar data": True,
                        "e": {"left": 0.0, "bottom": 0.0}},
                    "Neumann conditions": {
                        "e": {"right": "2.0 + y", "top": "x"}}},
        "Discretization": {"order": {"e": 1}, "quadrature": 2},
        "Solver": {"solver": "steady-state"},
    }


def check_against_jax_general(cfg, stage=None, tol=(1e-11, 1e-10, 1e-11),
                              provider=None):
    """The port's fused residual (with the boundary groups), J.apply(v),
    J.diag() and the structured matfree apply against the JAX package's
    general-path residual and Jacobian, at a seeded state, steady or at a
    stage of the given alphas."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(cfg)
    if stage is None:
        tj, tt = steady_coeffs(pj, pt)
    else:
        pj.assembler.is_transient = pt.assembler.is_transient = True
        tj, tt = stage_coeffs(pj, pt, *stage, seed=41, time=0.35)
    asm = pt.assembler
    fused = asm.fused_provider()
    assert fused is not None
    if provider is not None:
        assert type(fused).__name__ == provider
    assert asm._active_bnd_groups()
    u = seeded(pt.n_dof, seed=3)
    r, J = asm.res_and_jac(state_from_numpy(u, pt), tt)
    assert J.vol is None and J.bnd
    aj = pj.assembler
    uj = jnp.asarray(u)
    Jj = aj.jacobian(uj, tj)
    v = seeded(pt.n_dof, seed=7, scale=1.0)
    vt = state_from_numpy(v, pt)
    assert max_diff(r, aj.residual(uj, tj)) < tol[0]
    assert max_diff(J.apply(vt), Jj.apply(jnp.asarray(v))) < tol[1]
    assert max_diff(J.diag(), Jj.diag()) < tol[2]
    assert max_diff(asm.matfree_apply_fn(J)(vt), Jj.apply(jnp.asarray(v))) \
        < tol[1]
    return pj, pt


def test_fused_composes_with_boundary_groups():
    """The counterpart of the JAX package's test of that name: the fused
    thermal provider (B2) with a Neumann group equals JAX's general path
    to 1e-11 (residual), 1e-10 (apply) and 1e-11 (diag)."""
    pj, pt = check_against_jax_general(neumann_cfg(),
                                       provider="FusedP1Assembly")
    assert pt.assembler.fused_provider().split
    assert pt.bcs.var_bcs == pj.bcs.var_bcs
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)


def test_dense_jacobian_holds_the_boundary_blocks():
    """BlockJacobian.dense() sums the boundary blocks as apply does."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    pj, pt = both_problems(neumann_cfg())
    tj, tt = steady_coeffs(pj, pt)
    u = seeded(pt.n_dof, seed=3)
    _r, J = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    assert max_diff(J.dense(), Jj.dense()) < 1e-11


@pytest.mark.parametrize("mesh", ["hex", "p2"])
@pytest.mark.parametrize("kappa", ["1.0", "1.0 + e*e"])
def test_neumann_on_hex_and_p2(mesh, kappa):
    """Neumann fluxes on the element-tile kernels' decks (B1 "state" for
    kappa = 1, "full" for kappa = 1 + e*e), 3D hex and p2 quads."""
    cfg = hex_cfg(3, 2, 2, kappa=kappa) if mesh == "hex" \
        else p2_cfg(3, kappa=kappa)
    cfg["Physics"]["Dirichlet conditions"] = {"e": {"left": 0.0}}
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"top": "1.0 + x*y", "right": "0.5*y"}}
    check_against_jax_general(cfg, provider="FusedP1Assembly")


@pytest.mark.parametrize("kappa", ["1.0 + 0.5*x", "1.0 + e*e"])
def test_weak_dirichlet(kappa):
    """`use weak Dirichlet`: thermal's Nitsche terms (its weak Dirichlet
    data read as 'Dirichlet e <side>'), no strong row fixed."""
    cfg = thermal_cfg(4, kappa=kappa)
    cfg["Physics"]["use weak Dirichlet"] = True
    cfg["Functions"].update({f"Dirichlet e {s}": "0.25*x + y"
                             for s in ("left", "right", "bottom", "top")})
    _pj, pt = check_against_jax_general(cfg, provider="FusedP1Assembly")
    assert not bool(pt.assembler.fixed.any())
    assert set(pt.bcs.var_bcs["e"].values()) == {"weak Dirichlet"}


def test_weak_dirichlet_drops_the_condition_of_a_module_without_terms():
    """The JAX package's quirk, reproduced: `use weak Dirichlet` on cdr,
    which has no boundary_residual, leaves c with no condition at all
    (no fixed row, no boundary term)."""
    cfg = cdr_cfg(4, reaction="0.5*c*c")
    cfg["Physics"]["use weak Dirichlet"] = True
    pj, pt = check_against_jax_general(cfg, provider="FusedP1Assembly")
    assert not bool(pt.assembler.fixed.any())
    assert pj.bcs.fixed_dofs.size == 0


@pytest.mark.parametrize("kind", ["Neumann", "Far-field", "Slip"])
def test_conditions_without_a_module_term_add_nothing(kind):
    """The JAX package's quirk, reproduced: a Neumann, Far-field or Slip
    condition on a module with no boundary_residual (cdr) adds nothing,
    though its group is active."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    cfg = cdr_cfg(4)
    cfg["Physics"][f"{kind} conditions"] = {"c": {"top": "1.0 + x"}}
    base = cdr_cfg(4)
    pj, pt = check_against_jax_general(cfg)
    _pj0, pt0 = both_problems(base)
    u = state_from_numpy(seeded(pt.n_dof, seed=3), pt)
    _tj, tt = steady_coeffs(pj, pt)
    r, _J = pt.assembler.res_and_jac(u, tt)
    r0, _J0 = pt0.assembler.res_and_jac(u, tt)
    assert torch.equal(r, r0)


def test_flux_condition_on_cdr():
    """A Flux condition (the physics-agnostic -(g, v) term) on cdr's c,
    with a velocity and reaction, through the fused cdr provider."""
    cfg = cdr_cfg(4, vel="rot", reaction="0.5*c*c")
    cfg["Physics"]["Dirichlet conditions"] = {"c": {"left": 0.0,
                                                    "bottom": 0.0}}
    cfg["Physics"]["Flux conditions"] = {"c": {"top": "sin(pi*x)",
                                               "right": "0.5 + y"}}
    check_against_jax_general(cfg, provider="FusedP1Assembly")


@pytest.mark.parametrize("stage", [False, True])
def test_flux_condition_on_navier_stokes(stage):
    """A Flux condition on NS's ux at the outflow, through the NS
    provider (ns_node_full), steady and at a DIRK-2,2 stage."""
    cfg = channel_cfg(4, 2, supg=stage)
    cfg["Physics"]["Flux conditions"] = {"ux": {"right": "0.1*y*(1-y)"}}
    if stage:
        cfg["Solver"] = {"solver": "transient", "final time": 0.04,
                         "number of steps": 4}
    check_against_jax_general(cfg, NS_STAGE1 if stage else None,
                              provider="FusedNSAssembly")


def test_transient_stage_with_a_time_dependent_flux():
    """A DIRK-2,2 stage of a transient thermal deck whose Neumann flux
    reads t: the boundary part follows the stage's time (it is never in
    the per-stage coord cache), at two stages of the same betas."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    cfg = neumann_cfg()
    cfg["Physics"]["Neumann conditions"] = {"e": {"right": "sin(2*pi*t)*y",
                                                  "top": "x + t"}}
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Solver"] = {"solver": "transient", "final time": 0.2,
                     "number of steps": 4}
    pj, pt = check_against_jax_general(cfg, DIRK22_STAGE1)
    _tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=41, time=0.35)
    tj6, _tt6 = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=41, time=0.6)
    u = seeded(pt.n_dof, seed=3)
    r1, _ = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    tt.time = 0.6
    r2, _ = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    assert max_diff(r2, pj.assembler.residual(jnp.asarray(u), tj6)) < 1e-11
    assert max_diff(r1, r2) > 1e-3


def test_boundary_decks_launch_the_kernel_of_their_deck_without_them(
        monkeypatch):
    """A deck with boundary terms takes the same fused kernel as the same
    deck without them (each res_and_jac one call of it)."""
    from mrhyde_tpu_torch.interop import state_from_numpy
    from mrhyde_tpu_torch.ops import fused_elem, fused_p1
    calls = []
    for mod, name in ((fused_p1, "thermal_node_state"),
                      (fused_p1, "thermal_node_full"),
                      (fused_elem, "thermal_elem_state"),
                      (fused_elem, "thermal_elem_full")):
        orig = getattr(mod, name)

        def spy(*a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(*a, **k)
        monkeypatch.setattr(mod, name, spy)
    for kappa, mesh in (("1.0", "p1"), ("1.0 + e*e", "p1"),
                        ("1.0", "hex")):
        kernels = []
        for neumann in (False, True):
            cfg = thermal_cfg(4, kappa=kappa) if mesh == "p1" \
                else hex_cfg(2, 2, 2, kappa=kappa)
            if neumann:
                cfg["Physics"]["Dirichlet conditions"] = {
                    "e": {"left": 0.0}}
                cfg["Physics"]["Neumann conditions"] = {"e": {"top": "x"}}
            pj, pt = both_problems(cfg)
            _tj, tt = steady_coeffs(pj, pt)
            calls.clear()
            pt.assembler.res_and_jac(
                state_from_numpy(seeded(pt.n_dof, seed=1), pt), tt)
            kernels.append(list(calls))
        assert kernels[0] == kernels[1] and len(kernels[0]) == 1


def test_mixed_dirichlet_neumann_gold():
    """The JAX package's test_mixed_dirichlet_neumann deck (40^2, e = 0
    on the left and right, the Neumann flux of the true solution on the
    top and bottom) through Problem.run: its gold 0.00102733 at rtol
    2e-5."""
    from mrhyde_tpu_torch.problem import Problem
    import chip_smoke
    res = Problem(chip_smoke.mixed_neumann_deck(40), device="cpu").run()
    assert np.isclose(res.errors[("L2", "e")], 0.00102733, rtol=2e-5)


def test_point_dirichlet_conditions_name_their_roadmap_item():
    """Point Dirichlet conditions live on nodesets (of an Exodus mesh,
    here one handed in as `mesh=`): they pin the variable's dofs there
    to 0, as the JAX package's do, and a name no nodeset carries pins
    nothing (tests/test_torch_exodus.py runs them from a file)."""
    from mrhyde_tpu.mesh.structured import box_mesh as jax_box
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.mesh.structured import box_mesh
    from mrhyde_tpu_torch.problem import Problem
    cfg = thermal_cfg(4)
    cfg["Physics"]["e_point_DBCs"] = "corner"
    plain = Problem(thermal_cfg(4), device="cpu").bcs.fixed_dofs
    assert np.array_equal(Problem(cfg, device="cpu").bcs.fixed_dofs, plain)
    cfg["Physics"]["Dirichlet conditions"] = {"e": {"left": 0.0}}
    meshes = [box_mesh("quad", nx=4, ny=4), jax_box("quad", nx=4, ny=4)]
    for m in meshes:
        m.nodesets["corner"] = np.array([24], dtype=np.int32)
    pt = Problem(cfg, device="cpu", mesh=meshes[0])
    pj = JaxProblem(cfg, mesh=meshes[1])
    assert np.array_equal(pt.bcs.fixed_dofs, pj.bcs.fixed_dofs)
    # node 24, the corner (1, 1), is off the left side: the point
    # condition alone pins it
    left = Problem(cfg, device="cpu").bcs.fixed_dofs
    assert 24 in pt.bcs.fixed_dofs and 24 not in left


def test_interface_term_names_its_roadmap_item():
    """Thermal's multiscale interface term (ROADMAP A13, ported): the
    Nitsche coupling of a fine problem's sides to the macro trace "aux e"
    and the upscaled flux of compute_flux equal the JAX package's at a
    seeded fine state and trace (one macro element of the DtN2 deck,
    1e-13); the base module's boundary_residual adds nothing."""
    import chip_smoke as cs
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JTC
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.physics.base import PhysicsModule
    from mrhyde_tpu_torch.problem import Problem
    cfg = cs.multiscale_deck(2, 1)
    mj = JaxProblem(cfg).multiscale
    mt = Problem(cfg, device="cpu").multiscale
    nfd = mt.n_fine_dof
    uf, lam = seeded(nfd, seed=5, scale=1.0), seeded(4, seed=6, scale=1.0)
    z = np.zeros(nfd)
    tj = JTC.steady(9)
    geo_j = {k: v[1] for k, v in mj._percell(jnp.float64).items()}
    geo_t = {k: v[1] for k, v in mt._percell(torch.float64).items()}
    aux_j, aux_t = mj._make_aux(jnp.asarray(lam)), mt._make_aux(
        torch.tensor(lam))
    rj = mj._fine_residual(jnp.asarray(uf), jnp.asarray(z), jnp.asarray(z),
                           geo_j, aux_j, tj, None)
    t = torch.tensor
    rt = mt._fine_residual(t(uf), t(z), t(z), geo_t, aux_t,
                           (1.0, 0.0, 0.0, 1.0), mt.fa._params(None))
    fj = mj._flux_upscale(jnp.asarray(uf), jnp.asarray(z), geo_j, aux_j, tj,
                          None, jnp.zeros(4))
    ft = mt._flux_upscale(t(uf), t(z), geo_t, aux_t,
                          TimeCoeffs.steady(9), mt.fa._params(None))
    for a, b in ((rj, rt), (fj, ft)):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-13 * np.abs(a).max()
    assert PhysicsModule().boundary_residual(None) is None
