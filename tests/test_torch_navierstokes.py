"""Navier-Stokes and Stokes in the port: the general path's weak forms
(vmap'd element residual, vmap(jacfwd) Jacobian) against the JAX
package's general path, the element size h against JAX's Workset, and
flow decks end to end through `Problem(cfg).run()` and the CLI against
the reference's golds and JAX's live numbers.

Tolerances: 1e-11 absolute on the assembled residual and element
Jacobians (the same f64 weak form, other summation orders, O(10) entries
at most); rtol 2e-5 against the printed 6-digit golds; rtol 1e-9 against
JAX's live f64 error history (same discretization and solvers, other
summation orders, Newton converged to 1e-8)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrhyde_tpu_torch.interop import state_from_numpy, time_coeffs_from_numpy
from torch_port_utils import (FLOW_TRUE, both_problems, channel_cfg,
                              max_diff, seeded, startup_cfg, steady_coeffs)

torch.set_num_threads(1)

TOL = 1e-11
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lid_cfg(module):
    """tests/test_fused_p1.py's SUPG transient deck: the unit square, lid
    ux = 1 on top, viscosity 0.05."""
    cfg = channel_cfg(4, 4, module, supg=True, visc="0.05",
                      solver={"solver": "transient", "delta t": 0.1},
                      box=(1.0, 1.0))
    cfg["Physics"]["Dirichlet conditions"] = {
        "scalar data": True, "ux": {"bottom": 0.0, "top": 1.0}}
    return cfg


# name -> (config function, stage or None): JAX's own fused-path configs
# (tests/test_fused_p1.py:89-131) and a coordinate-dependent viscosity
GENERAL = {
    "pspg_channel_visc0.1": (lambda m: channel_cfg(4, 4, m, visc="0.1"),
                             None),
    "supg_lid_stage": (_lid_cfg, (1.0, 10.0, 0.2, 0.1)),
    "pspg_6x5_visc_x": (lambda m: channel_cfg(6, 5, m,
                                              visc="0.1 + 0.01*x"), None),
}


def _coeffs(pj, pt, stage):
    if stage is None:
        return steady_coeffs(pj, pt)
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    au, at, time, dt = stage
    rng = np.random.RandomState(5)
    bu = rng.randn(pj.n_dof) * 0.05
    bt = rng.randn(pj.n_dof) * 0.05
    tj = JaxTC(jnp.asarray(au), jnp.asarray(bu), jnp.asarray(at),
               jnp.asarray(bt), jnp.asarray(time), jnp.asarray(dt))
    return tj, time_coeffs_from_numpy(au, bu, at, bt, time, dt, pt)


@pytest.mark.parametrize("module", ["navier stokes", "Stokes"])
@pytest.mark.parametrize("name", sorted(GENERAL))
def test_general_path_matches_jax(name, module):
    build, stage = GENERAL[name]
    pj, pt = both_problems(build(module))
    assert pt.assembler.is_transient == (stage is not None)
    tj, tt = _coeffs(pj, pt, stage)
    u = seeded(pj.n_dof, seed=21)
    ut = state_from_numpy(u, pt)
    rj = pj.assembler.residual(jnp.asarray(u), tj)
    assert max_diff(pt.assembler.residual(ut, tt), rj) < TOL
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(ut, tt)
    assert max_diff(Jt.vol, Jj.vol) < TOL
    assert float(np.max(np.abs(np.asarray(Jj.vol)))) > 0.1


@pytest.mark.parametrize("cell", ["quad", "tri"])
def test_workset_h_matches_jax(cell):
    """h = (sum of the element's quadrature weights)^(1/dim), per element,
    on the channel's stretched quads and on triangles."""
    from mrhyde_tpu.assembly.workset import Workset as JaxWorkset
    from mrhyde_tpu_torch.assembly.workset import Workset
    cfg = channel_cfg(6, 5)
    cfg["Mesh"]["element type"] = cell
    pj, pt = both_problems(cfg)
    wts = np.asarray(pt.disc.wts)
    hs = []
    for e in range(0, wts.shape[0], 7):
        kw = dict(dim=2, ip=None, basis_vals={}, basis_grads={},
                  offsets={}, var_keys={})
        ht = Workset(wts=torch.as_tensor(wts[e]), u_eval=torch.zeros(1),
                     **kw).h
        hj = JaxWorkset(wts=jnp.asarray(wts[e]), u_eval=jnp.zeros(1),
                        **kw).h
        assert abs(float(ht) - float(hj)) < 1e-15
        hs.append(float(ht))
    if cell == "quad":
        # sqrt(hx hy) on the 5/6 x 1/5 channel elements, not hx
        assert hs[0] == pytest.approx(np.sqrt(5.0 / 6 * 1.0 / 5), rel=1e-14)


def test_stokes_pspg_gold_through_port():
    """stokes/2D_verification_pspg (tests/test_flow.py:12-32)."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = channel_cfg(4, 4, "Stokes", box=(1.0, 1.0), solver={
        "nonlinear TOL": 1e-10, "max nonlinear iters": 2})
    p = Problem(cfg, device="cpu")
    assert p.assembler.fused_provider() is None      # no qp density
    res = p.run()
    assert res.errors[("L2", "ux")] == pytest.approx(0.0188527, rel=2e-5)
    assert res.errors[("L2", "pr")] == pytest.approx(0.193776, rel=2e-5)
    assert res.errors[("L2", "uy")] == pytest.approx(0.00063617, rel=2e-5)


def test_ns_channel_gold_through_port():
    """navierstokes/channel (tests/test_flow.py:35-60), 50x10, direct
    solver, through the fused NS provider."""
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(channel_cfg(50, 10, solver={"use direct solver": True}),
                device="cpu")
    fused = p.assembler.fused_provider()
    assert type(fused).__name__ == "FusedNSAssembly"
    res = p.run()
    assert res.newton.converged
    assert fused.stats["n_jac_rows"] == 112 and fused.stats["steady"]
    assert res.errors[("L2", "ux")] == pytest.approx(0.00198075, rel=2e-5)
    assert res.errors[("L2", "pr")] == pytest.approx(0.0148536, rel=2e-5)
    assert res.errors[("L2", "uy")] == pytest.approx(0.000169464, rel=2e-5)


def test_startup_history_matches_jax():
    """The channel started from rest, 16x4: PSPG+SUPG, DIRK-2,2, 4 steps
    of 0.01, against JAX's error history at every recorded time."""
    pj, pt = both_problems(startup_cfg(16, 4))
    fused = pt.assembler.fused_provider()
    calls = []
    res_jac = fused.res_jac

    def counted(*a, **k):
        calls.append(1)
        return res_jac(*a, **k)
    fused.res_jac = counted
    ht = pt.run().error_history
    hj = pj.run().error_history
    assert calls and fused.stats["steady"] is False
    assert fused.stats["n_jac_rows"] == 144
    assert [t for t, _ in ht] == pytest.approx([t for t, _ in hj],
                                               abs=1e-14)
    assert len(ht) == 5
    for (_, et), (_, ej) in zip(ht, hj):
        for v in FLOW_TRUE:
            assert et[("L2", v)] == pytest.approx(ej[("L2", v)], rel=1e-9)


def test_cli_ns_deck_prints_the_jax_l2_lines(tmp_path):
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(channel_cfg(
        50, 10, solver={"use direct solver": True})))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"

    def l2_lines(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=600)
        assert out.returncode == 0, out.stderr
        return sorted(ln for ln in out.stdout.splitlines()
                      if "L2 norm of the error for" in ln)

    port = l2_lines([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                     str(deck), "--device", "cpu"])
    ref = l2_lines([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                    "--cpu", "--fp64"])
    assert len(port) == 3 and port == ref
    assert any("0.00198075" in ln for ln in port)
