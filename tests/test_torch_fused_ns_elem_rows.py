"""The port's fused Navier-Stokes provider on 3D hex (p1, nd = 32) and 2D
p2 quads (nd = 27), through the plain version of its element-tile kernel
(mrhyde_tpu_torch/ops/fused_ns.py `ns_elem_full_plain`):

- against the JAX package's general path on a 3x2x2 hex deck (residual,
  Jacobian blocks, apply and diag), as the JAX package's own tests hold
  its B1 (test_torch_fused_ns_elem.py holds it to the interpret-mode
  kernel);
- the row classes against JAX's probe, and the provider against the
  port's general path, also at Newton's line-search point;
- the wrapper, the first Newton step from rest, and end-to-end solves
  against the JAX package's error history, one through both CLIs.

Tolerances: 1e-10 absolute against JAX (the same f64 weak form, other
summation orders, entries up to O(10)); 1e-11 against the port's general
path; rtol 1e-9 on L2 against JAX's live f64 solves."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrhyde_tpu.ops.fused_p1 import FusedP1Assembly as JaxFused
from mrhyde_tpu_torch.interop import state_from_numpy, time_coeffs_from_numpy
from mrhyde_tpu_torch.ops import fused_ns as fn
from mrhyde_tpu_torch.ops import fused_p1 as fp
from torch_port_utils import (NS_STAGE1, _kind, both_problems, max_diff,
                              ns_elem_cfg, seeded, steady_coeffs)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_JAX, TOL = 1e-10, 1e-11
MESHES = {"hex": (3, 2, 2), "p2": (3, 2)}
VELS = {"hex": ("ux", "uy", "uz"), "p2": ("ux", "uy")}


@pytest.mark.parametrize("case", ["pspg_steady", "supg_stage"])
def test_hex_provider_matches_jax_general_path(case):
    """The provider on 3x2x2 hex against the JAX package's general path
    (how the JAX package's own tests hold its B1): residual, Jacobian
    blocks, apply and diag."""
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    stage = case == "supg_stage"
    cfg = ns_elem_cfg("hex", MESHES["hex"], supg=stage,
                      solver={"solver": "transient"} if stage else None)
    pj, pt = both_problems(cfg)
    n = pj.n_dof
    if stage:
        bu, bt = seeded(n, seed=31), seeded(n, seed=32, scale=5.0)
        tj = JaxTC(jnp.asarray(NS_STAGE1[0]), jnp.asarray(bu),
                   jnp.asarray(NS_STAGE1[1]), jnp.asarray(bt),
                   jnp.asarray(0.3), jnp.asarray(0.01))
        tt = time_coeffs_from_numpy(NS_STAGE1[0], bu, NS_STAGE1[1], bt, 0.3,
                                    0.01, pt)
    else:
        tj, tt = steady_coeffs(pj, pt)
    u = seeded(n, seed=21)
    r, J = pt.assembler.res_and_jac(state_from_numpy(u, pt), tt)
    assert pt.assembler.fused_provider().nd == 32 and J.vol is None
    asm = pj.assembler
    uj = jnp.asarray(u)
    Jj = asm.jacobian(uj, tj)
    assert max_diff(r, asm.residual(uj, tj)) < TOL_JAX
    assert max_diff(J.aos(), Jj.vol) < TOL_JAX
    v = seeded(n, seed=23, scale=1.0)
    assert max_diff(J.apply(torch.as_tensor(v)), Jj.apply(jnp.asarray(v))) \
        < TOL_JAX
    assert max_diff(J.diag(), Jj.diag()) < TOL_JAX


def _stage_coeffs(pt):
    n = pt.n_dof
    return time_coeffs_from_numpy(
        NS_STAGE1[0], seeded(n, seed=31), NS_STAGE1[1],
        seeded(n, seed=32, scale=5.0), 0.3, 0.01, pt)


# name -> (SUPG?, stage?, viscosity)
CLASSES = {
    "pspg_steady": (False, False, None),
    "pspg_steady_visc_x": (False, False, "0.1 + 0.01*x"),
    "supg_steady": (True, False, None),
    "pspg_stage": (False, True, None),
    "supg_stage_visc_x": (True, True, "0.1 + 0.01*x"),
}


def _pressure_block(mesh):
    """The momentum-pressure block: rows of the velocities against the
    columns of pr (24 x 8 on hex, 18 x 9 on p2)."""
    nv = len(VELS[mesh]) + 1
    nc = 8 if mesh == "hex" else 9
    nd = nv * nc
    return tuple(r * nd + (nv - 1) * nc + cp
                 for r in range((nv - 1) * nc) for cp in range(nc))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(CLASSES))
def test_row_classification_and_general_path(name, mesh):
    """The rows' kinds are those of JAX's probe (PSPG: the
    momentum-pressure block constant, whatever the viscosity; SUPG: every
    row varying), and the provider's residual, Jacobian, apply and diag
    match the port's general path, also at Newton's line-search point."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    supg, stage, visc = CLASSES[name]
    cfg = ns_elem_cfg(mesh, MESHES[mesh], supg=supg, visc=visc,
                      solver={"solver": "transient"} if stage else None)
    pt = Problem(cfg, device="cpu")
    asm = pt.assembler
    tt = _stage_coeffs(pt) if stage else TimeCoeffs.steady(pt.n_dof)
    ut = state_from_numpy(seeded(pt.n_dof, seed=22), pt)
    r, J = asm.res_and_jac(ut, tt)
    kinds = [_kind(x) for x in J.vol_soa]
    const = tuple(k for k, kd in enumerate(kinds) if kd == "scalar")
    assert const == (() if supg else _pressure_block(mesh))
    # JAX's probe of the same deck and call
    from mrhyde_tpu.problem import Problem as JaxProblem
    fk = JaxFused.build(JaxProblem(cfg).assembler)
    ft = asm.fused_provider()
    _res, jac_p = fk._probe(NS_STAGE1[0] if stage else 1.0,
                            NS_STAGE1[1] if stage else 0.0, 0.3, 0.01, {},
                            not stage, jnp.float64)
    assert kinds == [_kind(x) for x in jac_p]
    assert ft.stats["n_jac_rows"] == kinds.count("array")
    assert max_diff(r, asm.residual(ut, tt)) < TOL
    Jg = asm.jacobian(ut, tt)
    assert max_diff(J.aos(), Jg.vol) < TOL
    v = state_from_numpy(seeded(pt.n_dof, seed=23, scale=1.0), pt)
    assert max_diff(J.apply(v), Jg.apply(v)) < TOL
    assert J._aos_cache is not None       # varying rows: the AoS product
    assert max_diff(J.diag(), Jg.diag()) < TOL
    w = ut + 0.5 * v
    assert max_diff(asm.res_and_jac(w, tt)[0], asm.residual(w, tt)) < TOL


@pytest.mark.parametrize("supg", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_first_newton_step_from_rest_is_finite(mesh, supg):
    """At u = 0 tau takes its u2 branch: no derivative of sqrt at 0, so
    every row is finite and the pressure rows carry PSPG's tau."""
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.problem import Problem
    pt = Problem(ns_elem_cfg(mesh, MESHES[mesh], supg=supg), device="cpu")
    u0 = pt.initial_state()
    assert float(u0.abs().max()) == 0.0
    r, J = pt.assembler.res_and_jac(u0, TimeCoeffs.steady(pt.n_dof))
    rows = [x for x in J.vol_soa if x is not None]
    assert all(bool(torch.isfinite(x).all()) for x in rows)
    assert bool(torch.isfinite(r).all()) and float(r.abs().max()) > 0
    Jg = pt.assembler.jacobian(u0, TimeCoeffs.steady(pt.n_dof))
    assert max_diff(J.aos(), Jg.vol) < TOL
    nc = pt.assembler.fused_provider().nc
    p0 = nc * len(VELS[mesh])
    assert float(J.aos()[:, p0:, p0:].abs().max()) > 0


def _kernel_inputs(mesh, transient):
    """A provider's tables and lattice, seeded grids of a 3x2(x2) element
    grid, the viscosity per qp, a form and a stage."""
    from mrhyde_tpu_torch.problem import Problem
    f = Problem(ns_elem_cfg(mesh, MESHES[mesh]), device="cpu").assembler \
        .fused_provider()
    rng = np.random.RandomState(7)
    shape = (f.nv,) + tuple(f.grid_shape)
    ue = torch.as_tensor(rng.randn(*shape))
    ud = torch.as_tensor(rng.randn(*shape)) if transient else None
    E = int(np.prod(f.dims))
    visc = torch.as_tensor(0.1 + 0.01 * rng.rand(E, f.tables.Q))
    coeffs = (1.0, visc, 1.0) + (0.0,) * (f.dim - 1)
    form = fn.NSForm(True, transient, 0.4, 0.01, transient)
    stage = fp.Stage(*NS_STAGE1, None) if transient else None
    return f, ue, ud, coeffs, form, stage, E


@pytest.mark.parametrize("transient", [False, True])
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_wrapper_takes_plain_version_on_cpu_tensors(mesh, transient):
    f, ue, ud, coeffs, form, stage, E = _kernel_inputs(mesh, transient)
    block = set(_pressure_block(mesh))
    jac_idx = tuple(k for k in range(f.nd * f.nd)
                    if transient or k not in block)
    before = dict(fp.LAUNCHES)
    args = (ue, ud, coeffs, f.tables, f.lattice, form, jac_idx, stage)
    res, jac = fn.ns_elem_full(*args)
    rref, jref = fn.ns_elem_full_plain(*args)
    assert torch.equal(res, rref) and torch.equal(jac, jref)
    assert res.shape == (f.nd, E) and jac.shape == (len(jac_idx), E)
    assert fp.LAUNCHES == before          # plain versions launch nothing
    # a row the probe would call constant must not come back varying
    with pytest.raises(AssertionError):
        fn.ns_elem_full_plain(ue, ud, coeffs, f.tables, f.lattice, form,
                              jac_idx[1:], stage)


def test_hex_startup_history_matches_jax():
    """The channel on 8x2x2 hex started from rest: PSPG+SUPG, DIRK-2,2, 2
    steps of 0.01, through the provider, against JAX's error history at
    every recorded time."""
    cfg = ns_elem_cfg("hex", (8, 2, 2), supg=True, solver={
        "solver": "transient", "transient Butcher tableau": "DIRK-2,2",
        "final time": 0.02, "number of steps": 2, "nonlinear TOL": 1e-10})
    pj, pt = both_problems(cfg)
    fused = pt.assembler.fused_provider()
    assert fused is not None and not fused.node
    ht = pt.run().error_history
    hj = pj.run().error_history
    assert fused.stats["steady"] is False
    assert fused.stats["n_jac_rows"] == 1024
    assert [t for t, _ in ht] == pytest.approx([t for t, _ in hj],
                                               abs=1e-14)
    assert len(ht) == 3
    for (_, et), (_, ej) in zip(ht, hj):
        for v in (*VELS["hex"], "pr"):
            assert et[("L2", v)] == pytest.approx(ej[("L2", v)], rel=1e-9)


def test_p2_direct_solve_matches_jax():
    """The steady channel on 8x2 p2 quads, PSPG, direct: the port's
    Newton solve through the provider against the JAX package's
    Problem.run()."""
    from mrhyde_tpu_torch.interop import state_to_numpy
    cfg = ns_elem_cfg("p2", (8, 2), solver={"use direct solver": True,
                                            "nonlinear TOL": 1e-10})
    pj, pt = both_problems(cfg)
    assert not pt.assembler.fused_provider().node
    rt = pt.run()
    rj = pj.run()
    assert rt.newton.converged
    for v in (*VELS["p2"], "pr"):
        assert rt.errors[("L2", v)] == pytest.approx(rj.errors[("L2", v)],
                                                     rel=1e-9)
    assert np.max(np.abs(state_to_numpy(rt.u) - np.asarray(rj.u))) < 1e-10


def test_cli_hex_deck_prints_the_jax_l2_lines(tmp_path):
    """A steady hex channel deck through both CLIs: the same L2 lines;
    the port's --profile writes its timer report beside the deck."""
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(ns_elem_cfg(
        "hex", (8, 4, 2), solver={"use direct solver": True})))
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
                     str(deck), "--device", "cpu", "--profile"])
    ref = l2_lines([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                    "--cpu", "--fp64"])
    assert len(port) == 4 and port == ref
    report = (tmp_path / "mrhyde_tpu.profile").read_text()
    assert "driver::setup" in report and "driver::run" in report
