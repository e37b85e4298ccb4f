"""The adjoint in mrhyde_tpu_torch (`analysis/adjoint.py`, a
torch.autograd.Function per stage solve, and `analysis/forward_ad.py`)
against the JAX package's implicit-function custom_vjp on the CPU in
f64: the objective and its gradient in active scalars, an active vector
and a discretized field, steady and DIRK-2,2 (a dynamic field, one row
per step); the Hessian-vector product; the windowed rematerialization;
the transposed Krylov solve above the dense cutoff and the row-fixed
operators on the fused providers' SoA rows and on boundary blocks; the
forward on the fused kernels and the parameter product on the general
residual."""

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import (a12_pvec, adjoint_cfg,  # noqa: E402
                              advection_cfg)

torch.set_num_threads(1)


def _forwards(cfg):
    import copy
    from mrhyde_tpu.analysis.forward_ad import DifferentiableForward as JDF
    from mrhyde_tpu.problem import Problem as JP
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    from mrhyde_tpu_torch.problem import Problem
    pj, pt = JP(copy.deepcopy(cfg)), Problem(cfg, device="cpu")
    return (JDF(pj, pj.objective_manager.value),
            DifferentiableForward(pt, pt.objective_manager.value), pt)


_GRADIENTS = {}


def gradients(kind):
    """The JAX and port value_and_gradient of the deck at seeded
    parameters (a dynamic field in the DIRK-2,2 deck), once per module."""
    if kind not in _GRADIENTS:
        tr = kind == "dirk22"
        jf, tf, pt = _forwards(adjoint_cfg(5, transient=tr, dynamic=tr))
        pvj, pvt = a12_pvec(pt, seed=1)
        vj, gj = jf.value_and_gradient(pvj)
        vt, gt = tf.value_and_gradient(pvt)
        _GRADIENTS[kind] = (jf, pvj, vj, gj), (tf, pvt, vt, gt)
    return _GRADIENTS[kind]


@pytest.mark.parametrize("kind", ["steady", "dirk22"])
def test_value_and_gradient_matches_jax(kind):
    (_jf, pvj, vj, gj), (_tf, _pvt, vt, gt) = gradients(kind)
    assert abs(float(vt) - float(vj)) <= 1e-11 * abs(float(vj))
    assert sorted(gt) == sorted(gj) == ["k0", "k1", "kv", "src_field"]
    for k in gj:
        a, b = np.asarray(gj[k]), gt[k].numpy()
        assert b.shape == a.shape == np.shape(pvj[k])
        assert np.max(np.abs(a - b)) <= 1e-9 * np.max(np.abs(a)), k
    if kind == "dirk22":
        # the dynamic field: one gradient row per step, each live
        assert gt["src_field"].shape[0] == 3
        assert all(float(torch.abs(r).max()) > 0 for r in gt["src_field"])


def test_hvp_matches_jax():
    """d2J/dp2 . v reverse over reverse, against JAX's and against
    central differences of the gradient (the steady deck)."""
    import jax.numpy as jnp
    (jf, pvj, *_), (tf, pvt, *_) = gradients("steady")
    rng = np.random.RandomState(5)
    vec = {k: rng.uniform(-1, 1, np.shape(v)) for k, v in pvj.items()}
    hj = jf.hvp(pvj, {k: jnp.asarray(v) for k, v in vec.items()})
    ht = tf.hvp(pvt, vec)
    fd = tf.fd_hvp(pvt, vec)
    for k in hj:
        a = np.asarray(hj[k])
        assert np.max(np.abs(ht[k].numpy() - a)) <= 1e-9 * np.max(np.abs(a))
        assert np.max(np.abs(fd[k] - a)) <= 1e-5 * np.max(np.abs(a))


def test_windowed_gradient_equals_unwindowed():
    """'adjoint checkpoint window' 2 (torch.utils.checkpoint over two
    steps at a time) against one graph; windows engage by themselves
    from 40 steps, ceil(sqrt(n)) steps each."""
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    from mrhyde_tpu_torch.problem import Problem
    out = []
    for window in (-1, 2):
        cfg = adjoint_cfg(4, transient=True, field=False, steps=5)
        cfg["Solver"]["adjoint checkpoint window"] = window
        p = Problem(cfg, device="cpu")
        f = DifferentiableForward(p, p.objective_manager.value)
        assert f.window() == (0 if window < 0 else 2)
        out.append(f.value_and_gradient(p.param_manager.pvec()))
    (v0, g0), (v1, g1) = out
    assert abs(float(v0 - v1)) <= 1e-13 * abs(float(v0))
    for k in g0:
        assert torch.allclose(g0[k], g1[k], rtol=1e-12, atol=0), k
    cfg = adjoint_cfg(4, transient=True, field=False, steps=40)
    p = Problem(cfg, device="cpu")
    assert DifferentiableForward(p, p.objective_manager.value) \
        .window() == 7


def test_krylov_adjoint_matches_dense():
    """Above the dense cutoff the port solves the transposed system with
    the deck's Krylov method to its tolerance (GMRES + Jacobi here,
    forced by a cutoff of 0): the gradient equals the dense one."""
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    from mrhyde_tpu_torch.problem import Problem
    grads = []
    for cutoff in (4096, 0):
        cfg = adjoint_cfg(5, field=True)
        cfg["Solver"].update({"Belos solver": "Block GMRES",
                              "linear TOL": 1e-13})
        p = Problem(cfg, device="cpu")
        f = DifferentiableForward(p, p.objective_manager.value)
        f.stage_solve.dense_cutoff = cutoff
        assert f.stage_solve.dense == (cutoff > 0)
        grads.append(f.value_and_gradient(a12_pvec(p, seed=2)[1])[1])
        if not cutoff:
            assert f.stage_solve.counts["adjoint_iters"] > 0
    for k in grads[0]:
        a, b = grads[0][k], grads[1][k]
        assert float(torch.abs(a - b).max()) <= 1e-9 * float(
            torch.abs(a).max()), k


@pytest.mark.parametrize("fused", [True, False])
def test_rowfix_operators_on_soa_and_boundary_blocks(fused):
    """apply_rowfix(_T) and transposed() against the dense row-fixed
    matrix: the fused provider's SoA rows (nonsymmetric, with advection)
    and the general path's AoS blocks, both with Neumann boundary
    blocks."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    cfg = advection_cfg(4)
    cfg["Physics"]["Neumann conditions"] = {"e": {"top": "1.0 + x"}}
    p = Problem(cfg, device="cpu")
    asm = p.assembler
    rng = np.random.RandomState(3)
    u = torch.as_tensor(rng.randn(p.n_dof))
    v = torch.as_tensor(rng.randn(p.n_dof))
    tc = TimeCoeffs.steady(p.n_dof)
    J = asm.res_and_jac(u, tc)[1] if fused else asm.jacobian(u, tc)
    assert (J.vol is None) == fused and len(J.bnd) > 0
    A = J.dense_rowfix()
    assert torch.allclose(J.apply_rowfix(v), A @ v, rtol=0, atol=1e-12)
    assert torch.allclose(J.apply_rowfix_T(v), A.T @ v, rtol=0, atol=1e-12)
    assert torch.allclose(J.transposed().apply(v), J.dense().T @ v, rtol=0,
                          atol=1e-12)
    assert not torch.allclose(A, A.T)


def test_forward_runs_the_fused_kernels(monkeypatch):
    """A deck with scalar parameters: every Newton step and the backward's
    J~ come from the fused provider (B2 thermal_node_full's plain version
    here), the parameter product from the general Assembler.residual;
    the gradient equals central differences."""
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    from mrhyde_tpu_torch.assembly.assembler import Assembler
    from mrhyde_tpu_torch.ops.fused_p1 import FusedP1Assembly
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(cs.adjoint_nonlinear_deck(6), device="cpu")
    fused = p.assembler.fused_provider()
    assert type(fused) is FusedP1Assembly and not fused.split
    calls = {"fused": 0, "residual": 0}
    jac, res = fused.jacobian, Assembler.residual

    def fused_jac(*a, **k):
        calls["fused"] += 1
        return jac(*a, **k)

    def residual(self, *a, **k):
        calls["residual"] += 1
        return res(self, *a, **k)
    monkeypatch.setattr(fused, "jacobian", fused_jac)
    monkeypatch.setattr(Assembler, "residual", residual)
    f = DifferentiableForward(p, p.objective_manager.value)
    pvec = p.param_manager.pvec()
    _v, g = f.value_and_gradient(pvec)
    n = f.stage_solve.counts
    assert calls["fused"] == n["newton_iters"] + n["forward"] + n["adjoint"]
    assert calls["residual"] == n["adjoint"] == 1
    fd = f.fd_gradient(pvec, eps=1e-6)
    for k in g:
        assert abs(float(g[k]) - fd[k]) <= 1e-6 * abs(fd[k]), k



def _ns_gradient(cutoff, maxiter=2000):
    """value_and_gradient of int ux^2 in the active viscosity nu on a
    steady 48x12 NS channel (PSPG, GMRES + Jacobi; 1,911 DOFs), the
    forward Newton dense and the adjoint's transposed solve with the dense
    cutoff `cutoff` and at most `maxiter` Krylov iterations."""
    from mrhyde_tpu_torch.analysis.forward_ad import DifferentiableForward
    from mrhyde_tpu_torch.problem import Problem
    cfg = cs.ns_deck(48, 12, {"nonlinear TOL": 1e-10,
                              "Belos solver": "Block GMRES"})
    cfg["Functions"].update({"viscosity": "nu"})
    cfg["Parameters"] = {"nu": {"type": "scalar", "value": 0.5,
                                "usage": "active"}}
    cfg["Postprocess"] = {"compute errors": False, "Objective functions": {
        "ux2": {"type": "integrated response", "response": "ux*ux"}}}
    p = Problem(cfg, device="cpu")
    f = DifferentiableForward(p, p.objective_manager.value)
    sv = f.stage_solve
    sv.linear_maxiter = maxiter
    newton = sv.newton

    def dense_newton(*args):
        sv.dense_cutoff = 10 ** 6
        try:
            return newton(*args)
        finally:
            sv.dense_cutoff = cutoff
    sv.newton = dense_newton
    sv.dense_cutoff = cutoff
    value, grad = f.value_and_gradient(
        {"nu": torch.tensor(0.5, dtype=torch.float64)})
    return value, grad["nu"], sv.counts


def test_unconverged_krylov_adjoint_takes_the_dense_solve(monkeypatch):
    """C-6: where the transposed GMRES + Jacobi solve stops unconverged
    (2,000 iterations on the NS channel's saddle point) the adjoint
    solves J~^T densely, as it fits in memory: the gradient equals the
    dense one to 1e-9 (the port raised there before). Past the memory it
    returns the Krylov result with a warning giving the residual."""
    import warnings

    from mrhyde_tpu_torch.analysis import adjoint
    v_dense, g_dense, c_dense = _ns_gradient(10 ** 6)
    assert c_dense["adjoint_iters"] == 0
    v_kry, g_kry, c_kry = _ns_gradient(0)
    assert c_kry["adjoint_iters"] == 2000
    assert c_kry["adjoint_dense_fallback"] == 1
    assert float(v_kry) == float(v_dense)
    assert abs(float(g_kry - g_dense)) <= 1e-9 * abs(float(g_dense))
    monkeypatch.setattr(adjoint, "free_bytes", lambda device: 0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        _v, g_warn, c_warn = _ns_gradient(0, maxiter=50)
    assert c_warn["adjoint_dense_fallback"] == 0
    assert any("did not converge: residual" in str(w.message)
               for w in caught)
    assert bool(torch.isfinite(g_warn))
