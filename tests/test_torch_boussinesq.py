"""The Boussinesq coupling of Navier-Stokes and thermal in the port: the
general path's weak form (rho beta (e - T_ambient) source_d in each
momentum equation and its SUPG/PSPG strong residual) against the JAX
package's general path, the JAX package's Boussinesq deck
(tests/test_flow.py:63-98) solved by the port on the CPU through the
module-set provider, and a module-set deck through both CLIs.

Tolerances: 1e-11 absolute on the assembled residual and element
Jacobians (the same f64 weak form, other summation orders); rtol 1e-8 on
max |ux| of the Boussinesq deck against JAX's live f64 solve (direct
solver, Newton to 1e-10); the L2 lines the CLIs print, equal as
printed."""

import copy
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from mrhyde_tpu_torch.interop import (state_from_numpy,  # noqa: E402
                                      time_coeffs_from_numpy)
from torch_port_utils import (both_problems, max_diff,  # noqa: E402
                              ns_cdr_cfg, ns_thermal_cfg, seeded,
                              steady_coeffs)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_flow.py:63-98: NS + thermal, PSPG, beta 1, steady, direct
BOUSSINESQ = {
    "Mesh": {"dimension": 2, "element type": "quad", "NX": 8, "NY": 8},
    "Physics": {"modules": "navier stokes,thermal",
                "usePSPG": True, "beta": 1.0, "T_ambient": 0.0,
                "Dirichlet conditions": {
                    "scalar data": True,
                    "ux": {"all boundaries": 0.0},
                    "uy": {"all boundaries": 0.0},
                    "e": {"left": 1.0, "right": 0.0}}},
    "Functions": {"source uy": "-1.0", "source ux": "0.0",
                  "thermal source": "0.0"},
    "Discretization": {"order": {"ux": 1, "uy": 1, "pr": 1, "e": 1},
                       "quadrature": 2},
    "Solver": {"solver": "steady-state", "use direct solver": True,
               "max nonlinear iters": 8, "nonlinear TOL": 1e-10},
    "Postprocess": {"compute errors": False},
}


def _stage(pj, pt):
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    rng = np.random.RandomState(5)
    bu = rng.randn(pj.n_dof) * 0.05
    bt = rng.randn(pj.n_dof) * 0.05
    au, at, time, dt = 0.5, 200.0, 0.02, 0.01
    tj = JaxTC(jnp.asarray(au), jnp.asarray(bu), jnp.asarray(at),
               jnp.asarray(bt), jnp.asarray(time), jnp.asarray(dt))
    return tj, time_coeffs_from_numpy(au, bu, at, bt, time, dt, pt)


@pytest.mark.parametrize("case", ["pspg_steady", "advected_supg_stage"])
def test_general_path_matches_jax(case):
    stage = case != "pspg_steady"
    cfg = ns_thermal_cfg(advect=stage, supg=stage, transient=stage)
    pj, pt = both_problems(cfg)
    tj, tt = _stage(pj, pt) if stage else steady_coeffs(pj, pt)
    u = seeded(pj.n_dof, seed=21)
    ut = state_from_numpy(u, pt)
    rj = pj.assembler.residual(jnp.asarray(u), tj)
    assert max_diff(pt.assembler.residual(ut, tt), rj) < 1e-11
    Jj = pj.assembler.jacobian(jnp.asarray(u), tj)
    Jt = pt.assembler.jacobian(ut, tt)
    assert max_diff(Jt.vol, Jj.vol) < 1e-11
    # the Boussinesq term is in both: beta moves the momentum residual
    cfg0 = copy.deepcopy(cfg)
    cfg0["Physics"]["beta"] = 0.0
    p0 = both_problems(cfg0)[1]
    uy = torch.as_tensor(pt.disc.dofmap.all_dofs("uy"))
    assert float((p0.assembler.residual(ut, tt)
                  - pt.assembler.residual(ut, tt))[uy].abs().max()) > 1e-3


def test_boussinesq_deck_matches_jax():
    """max |ux| of the JAX package's Boussinesq deck against JAX's own
    solve; beta = 0 leaves no flow (< 1e-3 of it)."""
    from mrhyde_tpu.problem import Problem as JaxProblem
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    from mrhyde_tpu_torch.problem import Problem
    maxu = {}
    for beta in (1.0, 0.0):
        cfg = copy.deepcopy(BOUSSINESQ)
        cfg["Physics"]["beta"] = beta
        p = Problem(cfg, device="cpu", dtype=torch.float64)
        assert isinstance(p.assembler.fused_provider(), FusedSetAssembly)
        res = p.run()
        assert res.newton.converged
        dofs = torch.as_tensor(p.disc.dofmap.all_dofs("ux"))
        maxu[beta] = float(res.u[dofs].abs().max())
    pj = JaxProblem(copy.deepcopy(BOUSSINESQ))
    uj = np.asarray(pj.run().u)
    ref = float(np.abs(uj[np.asarray(pj.disc.dofmap.all_dofs("ux"))]).max())
    assert abs(maxu[1.0] - ref) <= 1e-8 * ref
    assert maxu[1.0] > 1e-6 and maxu[0.0] < 1e-3 * maxu[1.0]


def test_cli_set_deck_prints_the_jax_l2_lines(tmp_path):
    """NS + cdr (a module set) through both CLIs: the same L2 lines."""
    cfg = ns_cdr_cfg()
    cfg["Solver"]["use direct solver"] = True
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(cfg))
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
    assert len(port) >= 4 and port == ref
