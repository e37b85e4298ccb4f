"""The port's fused node-scatter provider (mrhyde_tpu_torch/ops/
fused_p1.py), with its kernels' plain versions on the CPU, against the
JAX package's FusedP1Assembly.res_jac in Pallas interpret mode, which
runs the node-scatter TPU kernel B2 on the CPU: residual, the kind of
each Jacobian row (None / element-independent scalar / (E,) array) and
its value, and the row classification (`fk.stats`); steady calls and
transient stages (seeded beta_u, beta_t handed to both packages).

Tolerance 1e-11 absolute: the same f64 weak form summed in the same
corner and quadrature order (a stage's coord residual as three node
sums: source, beta_u flux, beta_t mass), on O(1) entries."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
from mrhyde_tpu_torch.interop import state_from_numpy
from mrhyde_tpu_torch.ops import fused_p1 as fp
from torch_port_utils import (DIRK22_STAGE1, KAPPAS, MASSES, SOURCE_NL,
                              both_problems, check_fused_against_jax,
                              max_diff, seeded, stage_coeffs, steady_coeffs,
                              thermal_cfg, transient_cfg)

torch.set_num_threads(1)

TOL = 1e-11


@pytest.mark.parametrize("nx,ny", [(4, 4), (6, 5)])
@pytest.mark.parametrize("kappa", KAPPAS)
def test_fused_provider_matches_jax_node_kernel(kappa, nx, ny):
    cfg = thermal_cfg(nx, ny, kappa=kappa)
    if kappa == "1.0 + e*e":
        cfg["Functions"]["thermal source"] = SOURCE_NL
    pj, pt = both_problems(cfg)
    tj, tt = steady_coeffs(pj, pt)
    ft = check_fused_against_jax(pj, pt, tj, tt, seeded(pj.n_dof, seed=21),
                                 TOL)
    assert ft.node and ft.nc == 4


@pytest.mark.parametrize("kappa", KAPPAS)
def test_res_and_jac_engages_fused_and_matches_general(kappa):
    """On the CPU res_and_jac goes through the fused provider (plain
    kernels) and agrees with the port's general path."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(thermal_cfg(6, 5, kappa=kappa), device="cpu")
    tt = TimeCoeffs.steady(pt.n_dof)
    u = torch.as_tensor(seeded(pt.n_dof, seed=22))
    r, J = pt.assembler.res_and_jac(u, tt)
    assert J.vol is None and J.vol_soa is not None
    Jg = pt.assembler.jacobian(u, tt)
    assert max_diff(r, pt.assembler.residual(u, tt)) < TOL
    assert max_diff(J.aos(), Jg.vol) < TOL
    v = torch.as_tensor(seeded(pt.n_dof, seed=23, scale=1.0))
    assert max_diff(J.apply(v), Jg.apply(v)) < TOL
    assert max_diff(J.diag(), Jg.diag()) < TOL


def _transient_problems(nx, ny, kappa, mass):
    cfg = transient_cfg(nx, ny, kappa=kappa, mass=mass)
    if kappa == "1.0 + e*e":
        cfg["Functions"]["thermal source"] = SOURCE_NL
    return both_problems(cfg)


def _check_stage(pj, pt, tj, tt, u):
    """The port's provider at one stage against JAX's node kernel and
    the port's general path: residual, rows and their kinds, stats,
    BlockJacobian apply/diag; and the general residual at another point
    (Newton's backtracking residual) against the fused one there."""
    check_fused_against_jax(pj, pt, tj, tt, u, TOL)
    asm = pt.assembler
    ut = state_from_numpy(u, pt)
    r_t, J = asm.res_and_jac(ut, tt)
    v = seeded(pt.n_dof, seed=23, scale=1.0)
    # the general path: residual, Jacobian, and the residual Newton's
    # line search evaluates at u + alpha du
    assert max_diff(r_t, asm.residual(ut, tt)) < TOL
    assert max_diff(J.aos(), asm.jacobian(ut, tt).vol) < TOL
    w = ut + 0.5 * state_from_numpy(v, pt)
    assert max_diff(asm.res_and_jac(w, tt)[0], asm.residual(w, tt)) < TOL


@pytest.mark.parametrize("mass", MASSES, ids=["m1", "m2x"])
@pytest.mark.parametrize("kappa", KAPPAS)
@pytest.mark.parametrize("nx,ny", [(4, 4), (6, 5)])
def test_transient_provider_matches_jax_node_kernel(nx, ny, kappa, mass):
    """A DIRK-2,2 stage-1 call (alpha_u = 0.5, beta_u != 0)."""
    pj, pt = _transient_problems(nx, ny, kappa, mass)
    tj, tt = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=31)
    _check_stage(pj, pt, tj, tt, seeded(pj.n_dof, seed=21))


@pytest.mark.parametrize("kappa", KAPPAS)
def test_transient_provider_at_alpha_u_zero(kappa):
    """Crank-Nicolson's stage 0: alpha_u = 0, so the Jacobian is alpha_t
    M alone; nothing may divide by alpha_u."""
    pj, pt = _transient_problems(4, 4, kappa, MASSES[1])
    tj, tt = stage_coeffs(pj, pt, 0.0, 20.0, seed=33)
    _check_stage(pj, pt, tj, tt, seeded(pj.n_dof, seed=22))


def test_coord_cache_follows_beta():
    """Two stages at the same time with different betas (Crank-Nicolson's
    stage 1 and the next step's stage 0 share t + dt) must not share the
    cached coord part; within one stage it is computed once."""
    pj, pt = _transient_problems(6, 5, "1.0 + 0.5*x*y", MASSES[1])
    asm = pt.assembler
    ft = asm.fused_provider()
    evals = []
    coord_eval = ft._coord_eval

    def counted(*a, **k):
        evals.append(1)
        return coord_eval(*a, **k)
    ft._coord_eval = counted
    u = seeded(pj.n_dof, seed=24)
    ut = state_from_numpy(u, pt)
    _tj1, tt1 = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=41)
    asm.res_and_jac(ut, tt1)
    tj2, tt2 = stage_coeffs(pj, pt, *DIRK22_STAGE1, seed=43)
    assert tt2.time == tt1.time
    r2, J2 = asm.res_and_jac(ut, tt2)
    fk = JaxFused.build(pj.assembler)
    r_j, rows_j = fk.res_jac(jnp.asarray(u), tj2, None, interpret=True)
    assert max_diff(r2, r_j) < TOL
    assert max_diff(r2, asm.residual(ut, tt2)) < TOL
    assert max_diff(J2.aos(), asm.jacobian(ut, tt2).vol) < TOL
    for rj, rt in zip(rows_j, J2.vol_soa):
        assert max_diff(rt, rj) < TOL
    assert len(evals) == 2
    asm.res_and_jac(ut + 0.1, tt2)          # the stage's next iteration
    assert len(evals) == 2


def test_transient_coord_part_runs_state_kernel_on_betas(monkeypatch):
    """Under the split, a stage's first call runs the state kernel on the
    beta_u grid (alpha = (1, 0)) and the beta_t grid (alpha = (0, 1)) for
    the coord residual, then on u; the stage's later calls on u alone;
    a steady call on u alone, with no Stage."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    _pj, pt = _transient_problems(6, 5, "1.0 + 0.5*x*y", MASSES[1])
    asm = pt.assembler
    ft = asm.fused_provider()
    seen = []
    state = fp.thermal_node_state

    def recorded(u_grid, kappa, tab, stage=None, vel=None):
        seen.append((u_grid.clone(), None if stage is None
                     else (stage.alpha_u, stage.alpha_t)))
        return state(u_grid, kappa, tab, stage, vel)
    monkeypatch.setattr(fp, "thermal_node_state", recorded)
    ut = state_from_numpy(seeded(pt.n_dof, seed=25), pt)
    _tj, tt = stage_coeffs(_pj, pt, *DIRK22_STAGE1, seed=45)
    asm.res_and_jac(ut, tt)
    assert [s for _, s in seen] == [(1.0, 0.0), (0.0, 1.0), DIRK22_STAGE1]
    for (g, _), v in zip(seen, (tt.beta_u, tt.beta_t, ut)):
        assert torch.equal(g, ft._grid(v))
    asm.res_and_jac(ut + 0.1, tt)
    assert len(seen) == 4 and seen[3][1] == DIRK22_STAGE1
    asm.res_and_jac(ut, TimeCoeffs.steady(pt.n_dof))
    assert len(seen) == 5 and seen[4][1] is None


def _tables():
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(thermal_cfg(5, 3), device="cpu")
    return pt.assembler.fused_provider().tables


def test_wrappers_take_plain_versions_on_cpu_tensors():
    tab = _tables()
    rng = np.random.RandomState(31)
    u = torch.as_tensor(rng.randn(6, 4))
    E = 15
    qp = [torch.as_tensor(rng.randn(E, tab.Q)) for _ in range(4)]
    before = dict(fp.LAUNCHES)
    stage = fp.Stage(0.5, 40.0, qp[3])
    assert torch.equal(fp.thermal_node_state(u, qp[2], tab, stage),
                       fp.thermal_node_state_plain(u, qp[2], tab, stage))
    out, jac = fp.thermal_node_full(u, *qp, tab, fp.Stage(0.5, 40.0, 2.0))
    ref, jref = fp.thermal_node_full_plain(u, *qp, tab,
                                           fp.Stage(0.5, 40.0, 2.0))
    assert torch.equal(out, ref) and torch.equal(jac, jref)
    assert torch.equal(fp.thermal_node_state(u, 1.5, tab),
                       fp.thermal_node_state_plain(u, 1.5, tab))
    assert torch.equal(fp.thermal_node_state(u, qp[2], tab),
                       fp.thermal_node_state_plain(u, qp[2], tab))
    out, jac = fp.thermal_node_full(u, *qp, tab)
    ref, jref = fp.thermal_node_full_plain(u, *qp, tab)
    assert torch.equal(out, ref) and torch.equal(jac, jref)
    assert jac.shape == (16, E) and out.shape == u.shape
    assert fp.LAUNCHES == before          # plain versions launch nothing


def test_cuda_is_refused_without_a_card():
    """Asking for the card where there is none raises; nothing falls
    back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.runtime import resolve_device
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        Problem(thermal_cfg(4), device="cuda")
    tab = _tables()
    with pytest.raises(ValueError):
        fp.thermal_node_state(torch.zeros(5, 4, device="meta"), 1.0, tab)


def test_qp_density_matches_jax_thermal():
    """The port's thermal qp_density (the weak form the kernels hard-code)
    against the JAX module's on the same per-qp state."""
    from mrhyde_tpu.functions.manager import FunctionManager as JaxFM
    from mrhyde_tpu.physics.thermal import Thermal as JaxThermal
    from mrhyde_tpu_torch.functions.manager import FunctionManager
    from mrhyde_tpu_torch.physics.thermal import Thermal

    class Ctx:
        def __init__(self, fm, x, u, g):
            self.fm, self.x, self.u, self.g = fm, x, u, g

        def f(self, name):
            return self.fm.evaluate(name, self)

        def sol_dot(self, v):
            return 0.0

        def grad(self, v):
            return self.g

        def resolve(self, leaf):
            return {"x": self.x, "e": self.u}[leaf]

    fs = {"thermal diffusion": "1 + e*e + x", "thermal source": "sin(x)"}
    rng = np.random.RandomState(41)
    x, u, g0, g1 = (rng.randn(7) for _ in range(4))
    out = {}
    for name, mod, fm, arr in (("jax", JaxThermal, JaxFM(), jnp.asarray),
                               ("torch", Thermal, FunctionManager(),
                                torch.as_tensor)):
        m = mod({}, 2)
        m.define_functions(fm, fs)
        S, F = m.qp_density(Ctx(fm, arr(x), arr(u),
                                [arr(g0), arr(g1)]))["e"]
        out[name] = [np.asarray(S)] + [np.asarray(f) for f in F]
    for a, b in zip(out["torch"], out["jax"]):
        assert max_diff(a, b) < 1e-14
