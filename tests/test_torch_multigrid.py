"""The port's geometric multigrid (mrhyde_tpu_torch/solvers/multigrid.py)
against the JAX package's StructuredMG, in f64 on the CPU: the level
hierarchy (dims, lids, fixed masks, element groups, local interpolation)
exactly; prolong / restrict to rounding, and their adjointness; the
coarse operators and the V-cycle on the same BlockJacobian to 1e-12
relative; GMRES with the V-cycle in the same number of iterations or one
apart; and decks with the reference's ILUT smoother (multigrid) through
both packages' Problem, solutions to 1e-10 relative.

The cases: kappa = 1 + e^2 on 16^2 quads, thermal + cdr on 16 x 8 with a
Neumann flux on e that reads e and a Flux condition on c (2 variables,
the boundary blocks folded into the fine operator), kappa = 1 + e^2 on
an 8^3 hex mesh; coarse_dofs 20, so the small meshes still make 3-4
levels."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from mrhyde_tpu.solvers.krylov import gmres as jax_gmres  # noqa: E402
from mrhyde_tpu.solvers.multigrid import \
    StructuredMG as JaxMG  # noqa: E402
from mrhyde_tpu_torch.solvers.krylov import gmres  # noqa: E402
from mrhyde_tpu_torch.solvers.multigrid import StructuredMG  # noqa: E402
from chip_smoke import smoother, with_solver  # noqa: E402
from torch_port_utils import (both_problems, hex_cfg,  # noqa: E402
                              rel_diff, same_jacobians, seeded,
                              startup_cfg, thermal_cdr_affine_cfg,
                              thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-12
COARSE = 20


def _set_cfg():
    """thermal + cdr on 16 x 8, its Neumann flux on e reading e (so the
    boundary blocks are not zero)."""
    cfg = thermal_cdr_affine_cfg("p1")
    cfg["Mesh"].update({"NX": 16, "NY": 8})
    cfg["Physics"]["Neumann conditions"] = {
        "e": {"top": "2.0 + y + 0.5*e*e"}}
    return cfg


CASES = {
    "thermal_16": (lambda: thermal_cfg(16, kappa="1.0 + e*e"), 4),
    "set_neumann_16x8": (_set_cfg, 3),
    "hex_8": (lambda: hex_cfg(8, 8, 8, kappa="1.0 + e*e"), 3),
}

_CACHE = {}


def _case(name):
    """(JAX J, torch J, JAX hierarchy, torch hierarchy), built once per
    case."""
    if name not in _CACHE:
        pj, pt, Jj, Jt = same_jacobians(CASES[name][0]())
        _CACHE[name] = (Jj, Jt, JaxMG(pj.assembler, coarse_dofs=COARSE),
                        StructuredMG(pt.assembler, coarse_dofs=COARSE))
    return _CACHE[name]


def _jax_vcycle(mj, Jj):
    """JAX's V-cycle as one jitted program (its eager ops compile one by
    one)."""
    return jax.jit(lambda v: mj.preconditioner(Jj)(v))


@pytest.mark.parametrize("name", list(CASES))
def test_levels_match_jax(name):
    _Jj, _Jt, mj, mt = _case(name)
    assert mt.n_levels == mj.n_levels == CASES[name][1]
    assert mt.dims == mj.dims and mt.grids == mj.grids
    assert mt.ndof == mj.ndof and mt.starts == mj.starts
    assert mt.n_var == mj.n_var and mt.nd == mj.nd
    for li in range(mt.n_levels):
        assert np.array_equal(mt.lids[li].numpy(), np.asarray(mj.lids[li]))
        assert np.array_equal(mt.fixed_j[li].numpy(),
                              np.asarray(mj.fixed_j[li]))
    assert mt.fixed[0].any() and all(f.any() for f in mt.fixed)
    for gt, gj in zip(mt.group, mj.group):
        assert np.array_equal(gt.numpy(), np.asarray(gj))
    assert np.array_equal(mt.P_sub.numpy(), np.asarray(mj.P_sub))


@pytest.mark.parametrize("name", list(CASES))
def test_transfers_match_jax_and_are_adjoint(name):
    _Jj, _Jt, mj, mt = _case(name)
    for li in range(mt.n_levels - 1):
        vc = seeded(mt.ndof[li + 1], seed=li, scale=1.0)
        vf = seeded(mt.ndof[li], seed=10 + li, scale=1.0)
        pt_ = mt.prolong(li, torch.as_tensor(vc))
        rt_ = mt.restrict(li, torch.as_tensor(vf))
        pj_ = jax.jit(mj.prolong, static_argnums=0)(li, jnp.asarray(vc))
        rj_ = jax.jit(mj.restrict, static_argnums=0)(li, jnp.asarray(vf))
        assert rel_diff(pt_, np.asarray(pj_)) < 1e-15
        assert rel_diff(rt_, np.asarray(rj_)) < 1e-15
        # <P vc, vf> == <vc, R vf>
        lhs = float(torch.dot(pt_, torch.as_tensor(vf)))
        rhs = float(torch.dot(torch.as_tensor(vc), rt_))
        assert np.isclose(lhs, rhs, rtol=1e-12)


@pytest.mark.parametrize("name", list(CASES))
def test_operators_match_jax(name):
    Jj, Jt, mj, mt = _case(name)
    bt, bj = mt.operators(Jt), jax.jit(lambda: mj.operators(Jj))()
    assert len(bt) == len(bj) == mt.n_levels
    for t, j in zip(bt, bj):
        assert t.shape == j.shape
        assert rel_diff(t, np.asarray(j)) < TOL
    # the boundary groups' blocks are folded into the fine operator
    assert bool(Jt.bnd) == (name == "set_neumann_16x8")
    if Jt.bnd:
        assert float((bt[0] - Jt.aos()).abs().max()) > 0


@pytest.mark.parametrize("name", list(CASES))
def test_vcycle_matches_jax(name):
    Jj, Jt, mj, mt = _case(name)
    v = seeded(Jt.n_dof, seed=4, scale=1.0)
    zt = mt.preconditioner(Jt)(torch.as_tensor(v))
    zj = np.asarray(_jax_vcycle(mj, Jj)(jnp.asarray(v)))
    assert rel_diff(zt, zj) < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_gmres_with_the_vcycle_matches_jax(name):
    Jj, Jt, mj, mt = _case(name)
    b = seeded(Jt.n_dof, seed=8, scale=1.0)
    xj, ij = jax_gmres(Jj.apply, jnp.asarray(b), m=40, tol=1e-10,
                       max_restarts=10, precond=_jax_vcycle(mj, Jj))
    xt, it = gmres(Jt.apply, torch.as_tensor(b), m=40, tol=1e-10,
                   max_restarts=10, precond=mt.preconditioner(Jt))
    assert bool(ij.converged) and it.converged
    assert abs(int(ij.iters) - it.iters) <= 1
    assert rel_diff(xt, np.asarray(xj)) < 1e-10


def test_the_assembler_dof_order_is_held():
    """StructuredMG reads the dofs as var-major node grids in the
    structured plan's corner order, and refuses an assembler whose
    element lids say otherwise (not a ValueError: the Newton step's
    hierarchy choice must not take it for a mesh it does not take)."""
    from mrhyde_tpu_torch.problem import Problem
    asm = Problem(_set_cfg(), device="cpu").assembler
    StructuredMG(asm)
    asm.lids = asm.lids[:, [1, 0, 2, 3, 4, 5, 6, 7]]
    with pytest.raises(RuntimeError, match="var-major"):
        StructuredMG(asm)


ILUT = {"Belos solver": "Block GMRES", "nonlinear TOL": 1e-10,
        **smoother("ILUT")}
DECKS = {
    "quad": lambda: with_solver(thermal_cfg(16, kappa="1.0 + e*e"), **ILUT),
    "set_neumann": lambda: with_solver(_set_cfg(), **ILUT),
    "hex": lambda: with_solver(hex_cfg(6, 6, 6, kappa="1.0 + e*e"), **ILUT),
    "variant_mg": lambda: with_solver(thermal_cfg(16), **{
        "preconditioner variant": "mg", "nonlinear TOL": 1e-10}),
    # three variables, a DIRK-2,2 start-up: the hierarchy built once
    # serves every stage's Newton steps
    "ns_startup": lambda: with_solver(startup_cfg(16, 4), **{
        "Belos solver": "Block GMRES", "final time": 0.02,
        "number of steps": 2}, **smoother("ILUT")),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_multigrid_decks_match_jax(name):
    """The deck keys that take multigrid (an ILU smoother, the variant
    mg): StructuredMG built once per assembler, its V-cycle preconditions
    every Newton step's GMRES."""
    pj, pt = both_problems(DECKS[name]())
    assert pt._linear_method() == "gmres"
    rj, rt = pj.run(), pt.run()
    assert isinstance(pt.assembler.__dict__["_mg_hierarchy"], StructuredMG)
    if rt.newton is not None:
        assert rt.newton.converged and rt.newton.linear_converged
    assert rel_diff(rt.u, np.asarray(rj.u)) < 1e-10
    for (tj, ej), (tt, et) in zip(rj.error_history, rt.error_history):
        assert abs(float(tj) - tt) < 1e-12
        for key, val in et.items():
            assert abs(float(val) - float(ej[key])) <= 1e-10 * abs(
                float(ej[key])) + 1e-15


def test_build_mg_preconditioner_caches_the_hierarchy():
    """build_mg_preconditioner: StructuredMG built at the first call and
    cached on the assembler, its V-cycle over the given Jacobian."""
    from mrhyde_tpu_torch.solvers.multigrid import build_mg_preconditioner
    Jj, Jt, mj, mt = _case("thermal_16")
    asm = mt.asm
    asm.__dict__.pop("_mg_hierarchy", None)
    v = torch.as_tensor(seeded(Jt.n_dof, seed=9, scale=1.0))
    z = build_mg_preconditioner(asm, Jt)(v)
    hier = asm.__dict__["_mg_hierarchy"]
    assert isinstance(hier, StructuredMG)
    build_mg_preconditioner(asm, Jt)
    assert asm.__dict__["_mg_hierarchy"] is hier
    assert rel_diff(z, hier.preconditioner(Jt)(v)) == 0.0
