"""The port's aggregation AMG (mrhyde_tpu_torch/solvers/amg.py) against
the JAX package's AggregationAMG, in f64 on the CPU: the aggregate maps
and level lids exactly (the same numpy on the same mesh), the V-cycle on
the same BlockJacobian to 1e-12 relative, GMRES with it in the same
number of iterations or one apart; and decks that reach AMG through both
packages' Problem (multigrid on a tri mesh, an ILU smoother on p2 quads,
the variant amg on p1 quads), solutions to 1e-10 relative, and the
element-Schwarz fallback where neither hierarchy takes the mesh."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

from mrhyde_tpu.solvers.amg import AggregationAMG as JaxAMG  # noqa: E402
from mrhyde_tpu.solvers.krylov import gmres as jax_gmres  # noqa: E402
from mrhyde_tpu_torch.solvers.amg import AggregationAMG  # noqa: E402
from mrhyde_tpu_torch.solvers.krylov import gmres  # noqa: E402
from chip_smoke import smoother, with_solver  # noqa: E402
from torch_port_utils import (both_problems, cdr_cfg,  # noqa: E402
                              rel_diff, same_jacobians, seeded,
                              thermal_cfg)

torch.set_num_threads(1)

TOL = 1e-12
COARSE = 5


def tri_cfg(n, solver=None):
    """The thermal deck on n x n tri p1 (tests/test_amg.py's)."""
    cfg = thermal_cfg(n, solver=solver)
    cfg["Mesh"]["element type"] = "tri"
    return cfg


CASES = {
    "tri_12": lambda: tri_cfg(12),
    "p2_8": lambda: cdr_cfg(8, order=2),
}

_CACHE = {}


def _case(name):
    """(JAX J, torch J, JAX hierarchy, torch hierarchy), built once per
    case."""
    if name not in _CACHE:
        pj, pt, Jj, Jt = same_jacobians(CASES[name]())
        _CACHE[name] = (Jj, Jt, JaxAMG(pj.assembler, coarse_dofs=COARSE),
                        AggregationAMG(pt.assembler, coarse_dofs=COARSE))
    return _CACHE[name]


@pytest.mark.parametrize("name", list(CASES))
def test_aggregates_match_jax(name):
    _Jj, _Jt, aj, at = _case(name)
    assert at.n_levels == aj.n_levels >= 3
    assert at.sizes == aj.sizes
    for gt, gj in zip(at.aggs, aj.aggs):
        assert np.array_equal(gt, gj)
    for a, b in zip(at.level_lids, aj.level_lids):
        assert np.array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(at.agg_valid, aj.agg_valid):
        assert np.array_equal(a.numpy(), np.asarray(b))
    # the fixed dofs map nowhere
    assert (at.aggs[0][_Jt.fixed.numpy()] == -1).all()


def _jax_vcycle(aj, Jj):
    return jax.jit(lambda v: aj.preconditioner(Jj)(v))


@pytest.mark.parametrize("name", list(CASES))
def test_vcycle_matches_jax(name):
    Jj, Jt, aj, at = _case(name)
    v = seeded(Jt.n_dof, seed=4, scale=1.0)
    zt = at.preconditioner(Jt)(torch.as_tensor(v))
    zj = np.asarray(_jax_vcycle(aj, Jj)(jnp.asarray(v)))
    assert rel_diff(zt, zj) < TOL


@pytest.mark.parametrize("name", list(CASES))
def test_gmres_with_amg_matches_jax(name):
    Jj, Jt, aj, at = _case(name)
    b = seeded(Jt.n_dof, seed=8, scale=1.0)
    xj, ij = jax_gmres(Jj.apply, jnp.asarray(b), m=40, tol=1e-10,
                       max_restarts=10, precond=_jax_vcycle(aj, Jj))
    xt, it = gmres(Jt.apply, torch.as_tensor(b), m=40, tol=1e-10,
                   max_restarts=10, precond=at.preconditioner(Jt))
    assert bool(ij.converged) and it.converged
    assert abs(int(ij.iters) - it.iters) <= 1
    assert rel_diff(xt, np.asarray(xj)) < 1e-10


GMRES = {"Belos solver": "Block GMRES", "nonlinear TOL": 1e-10}
# (deck, the hierarchy Problem.run() caches on the assembler)
DECKS = {
    # StructuredMG refuses tri: AggregationAMG (1,089 dofs)
    "tri_multigrid": (lambda: tri_cfg(32, {
        "preconditioner variant": "multigrid", "nonlinear TOL": 1e-10}),
        AggregationAMG),
    # StructuredMG refuses p2 (1,089 dofs)
    "p2_ilut": (lambda: with_solver(cdr_cfg(16, order=2), **GMRES,
                                    **smoother("ILUT")), AggregationAMG),
    # the variant amg skips StructuredMG on a structured p1 mesh
    "quad_amg": (lambda: with_solver(thermal_cfg(32, kappa="1.0 + e*e"),
                                     **GMRES, **{
                                         "preconditioner variant": "amg"}),
                 AggregationAMG),
    # tests/test_amg.py's 20 x 20 tri deck: 441 dofs, too small for AMG's
    # coarse level of 600, so neither hierarchy takes it: element-Schwarz
    "tri_schwarz_fallback": (lambda: tri_cfg(20, {
        "preconditioner variant": "multigrid", "nonlinear TOL": 1e-10}),
        type(None)),
}


@pytest.mark.parametrize("name", list(DECKS))
def test_amg_decks_match_jax(name):
    build, hier = DECKS[name]
    pj, pt = both_problems(build())
    assert pt._linear_method() == "gmres"
    rj, rt = pj.run(), pt.run()
    assert type(pt.assembler.__dict__["_mg_hierarchy"]) is hier
    assert type(pj.assembler.__dict__["_mg_hierarchy"]).__name__ == \
        hier.__name__
    assert rt.newton.converged and rt.newton.linear_converged
    assert rel_diff(rt.u, np.asarray(rj.u)) < 1e-10
