"""The port end to end on the CPU: decks through `Problem(cfg).run()`
and the CLI, against the reference gold and the JAX package's live
numbers, and the port's independence from jax.

Tolerances: rtol 2e-5 against the printed 6-digit gold (the repo's gold
default); rtol 1e-9 against JAX's live f64 number (same discretization
and solver, different summation order); the CLI lines are compared as
printed (6 significant digits)."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mrhyde_tpu_torch.interop import (params_from_numpy, state_from_numpy,
                                      state_to_numpy)
from torch_port_utils import (SOURCE_NL, both_problems, channel_cfg,
                              thermal_cfg, transient_cfg)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DECKS = {
    # thermal/2D_verification: NX=NY=40 p1, gold L2(e) = 0.00102776
    "kappa1": (thermal_cfg(40), 0.00102776),
    # kappa = 1 + e^2 with its manufactured source (JAX f64 reference)
    "kappa_nl": (thermal_cfg(40, kappa="1.0 + e*e", source=SOURCE_NL,
                             solver={"nonlinear TOL": 1e-10}), 0.00102798),
}


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"
    return env


@pytest.mark.parametrize("name", sorted(DECKS))
def test_deck_matches_gold_and_jax(name):
    cfg, gold = DECKS[name]
    pj, pt = both_problems(cfg)
    rt = pt.run()
    l2 = rt.errors[("L2", "e")]
    assert l2 == pytest.approx(gold, rel=2e-5)
    assert rt.newton.converged
    rj = pj.run()
    assert l2 == pytest.approx(rj.errors[("L2", "e")], rel=1e-9)
    assert np.max(np.abs(state_to_numpy(rt.u) - np.asarray(rj.u))) < 1e-10


def test_state_and_params_cross_between_packages():
    """A JAX solution handed across is a solution of the port's system,
    and scalar Parameters reach both packages' expressions alike."""
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    cfg = thermal_cfg(8, 6, kappa="1.0 + kp*x*y")
    pj, pt = both_problems(cfg)
    pv = {"kp": 0.5}
    rj = pj.solve_steady(pvec={"kp": jnp.asarray(0.5)})
    u = state_from_numpy(np.asarray(rj.u), pt)
    assert u.dtype == pt.dtype and u.device == pt.device
    tc = TimeCoeffs.steady(pt.n_dof)
    pvec = params_from_numpy(pv)
    r = pt.assembler.residual(u, tc, pvec)
    assert float(torch.linalg.norm(r)) < 1e-12
    rf, _J = pt.assembler.res_and_jac(u, tc, pvec)
    rjax = pj.assembler.residual(rj.u, JaxTC.steady(pj.n_dof), {"kp": 0.5})
    assert np.max(np.abs(state_to_numpy(rf) - np.asarray(rjax))) < 1e-12
    rt = pt.solve_steady(pvec=pvec)
    assert np.max(np.abs(state_to_numpy(rt.u) - np.asarray(rj.u))) < 1e-10
    with pytest.raises(ValueError):
        params_from_numpy({"kp": [1.0, 2.0]})


def test_cli_prints_the_jax_l2_line(tmp_path):
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(DECKS["kappa1"][0]))

    def l2_line(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True,
                             env=_env(), cwd=tmp_path, timeout=600)
        assert out.returncode == 0, out.stderr
        lines = [ln for ln in out.stdout.splitlines()
                 if "L2 norm of the error for e" in ln]
        assert len(lines) == 1, out.stdout
        return lines[0]

    port = l2_line([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                    str(deck), "--device", "cpu"])
    ref = l2_line([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                   "--cpu", "--fp64"])
    assert port == ref
    assert "0.00102776" in port


@pytest.mark.parametrize("ic_type,nx,time", [
    ("L2-projection", 8, 0.0), ("L2-projection", 80, 0.3),
    ("interpolation", 8, 0.3)])
def test_initial_state_matches_jax(ic_type, nx, time):
    """Initial conditions: L2 projection (direct solve up to 6000 DOFs,
    CG above) and nodal interpolation, with the Dirichlet values written
    in, against JAX (1e-11)."""
    cfg = transient_cfg(nx, ic="x*(1-x)*y + 0.5*t + 0.25",
                        solver={"initial type": ic_type})
    pj, pt = both_problems(cfg)
    assert pt._proj_method() == ("direct" if nx == 8 else "cg")
    uj = np.asarray(pj.initial_state(time=time))
    ut = state_to_numpy(pt.initial_state(time=time))
    assert np.max(np.abs(ut - uj)) < 1e-11
    assert np.max(np.abs(ut)) > 0.25


def test_cli_prints_the_jax_transient_report(tmp_path):
    """A transient deck's report: one L2 line per recorded time, as the
    JAX CLI prints them."""
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(transient_cfg(
        8, solver={"transient Butcher tableau": "DIRK-2,2"})))

    def l2_lines(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True,
                             env=_env(), cwd=tmp_path, timeout=600)
        assert out.returncode == 0, out.stderr
        return [ln for ln in out.stdout.splitlines()
                if "L2 norm of the error for e" in ln]

    port = l2_lines([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                     str(deck), "--device", "cpu"])
    ref = l2_lines([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                    "--cpu", "--fp64"])
    assert len(port) == 5 and port == ref
    assert port[-1].endswith("(time = 0.2)")


def test_port_runs_without_importing_jax():
    code = ("import sys\n"
            "from mrhyde_tpu_torch.problem import Problem\n"
            "sys.path.insert(0, 'tests')\n"
            "from torch_port_utils import thermal_cfg, transient_cfg\n"
            "r = Problem(thermal_cfg(8), device='cpu').run()\n"
            "assert r.errors\n"
            "r = Problem(transient_cfg(6, solver={'transient Butcher "
            "tableau': 'DIRK-2,2'}), device='cpu').run()\n"
            "assert len(r.error_history) == 5 and r.time > 0.19\n"
            "from torch_port_utils import channel_cfg\n"
            "p = Problem(channel_cfg(10, 2, solver={'use direct solver': "
            "True}), device='cpu')\n"
            "assert type(p.assembler.fused_provider()).__name__ == "
            "'FusedNSAssembly'\n"
            "r = p.run()\n"
            "assert r.newton.converged and ('L2', 'pr') in r.errors\n"
            "from torch_port_utils import cdr_cfg\n"
            "r = Problem(cdr_cfg(6, vel='rot', reaction='0.5*c*c'), "
            "device='cpu').run()\n"
            "assert r.newton.converged and ('L2', 'c') in r.errors\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'mrhyde_tpu.')) or m == 'mrhyde_tpu']\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(), cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


HEX = {"dimension": 3, "element type": "hex", "NX": 2, "NY": 2, "NZ": 2}


@pytest.mark.parametrize("cfg_patch,item", [
    # sharding (A14, ported): builds; the case keeps its id
    pytest.param({"Solver": {"shards": 2}}, None, id="cfg_patch0-A14"),
    # a discretized (field) parameter, an analysis, integrated
    # quantities, a multi-set key and the solution writer: A12, ported
    ({"Parameters": {"kp": {"type": "HGRAD", "usage": "discretized",
                            "initial_value": 1.0}}}, None),
    ({"Analysis": {"analysis type": "ROL"}}, None),
    ({"Postprocess": {"compute integrated quantities": True}}, None),
    # a Subgrid sublist (A13, ported): builds; the case keeps its id
    pytest.param({"Subgrid": {"Mesh": {"refinements": 1},
                              "Physics": {"modules": "thermal"}}}, None,
                 id="cfg_patch4-A13"),
    ({"Physics": {"physics set names": "a, b"}}, None),
    ({"Postprocess": {"write solution": True}}, None),
])
def test_unported_deck_features_raise(cfg_patch, item):
    """A deck feature left unported raises naming its ROADMAP item; none
    is left: A12's, A13's and A14's (`Solver: shards`) build (a Problem
    ignores a multi-set key, which make_problem reads)."""
    from mrhyde_tpu_torch.problem import Problem
    cfg = thermal_cfg(4)
    for k, v in cfg_patch.items():
        cfg[k] = dict(cfg.get(k, {}), **v)
    if item is None:
        assert Problem(cfg, device="cpu").n_dof == 25
        return
    with pytest.raises(NotImplementedError, match=item):
        Problem(cfg, device="cpu")


@pytest.mark.parametrize("cfg_patch", [
    # on hex (the element-tile kernels B1; a velocity or NS coefficient
    # that reads the state itself, and an NS + thermal set, run on the
    # module-set kernels, tests/test_torch_fused_set*.py): an advection
    # velocity that reads the state's gradient
    {"Mesh": HEX, "Physics": {"modules": "cdr", "Dirichlet conditions": {
        "c": {"all boundaries": 0.0}}}, "Functions": {"xvel": "grad(c)[x]"}},
    # an NS + thermal set whose viscosity reads a gradient
    {"Mesh": HEX, "Physics": {"modules": "navier stokes,thermal"},
     "Functions": {"viscosity": "1.0 + grad(e)[x]"}},
    # an NS coefficient that reads a time derivative
    {"Mesh": HEX, "Physics": {"modules": "navier stokes"},
     "Functions": {"viscosity": "1.0 + ux_t"}},
])
def test_gradient_and_rate_coefficients_take_the_general_path(cfg_patch):
    """Coefficients that read a gradient or a time derivative have no
    kernel form in either package: the port takes the general path, as
    the JAX package's default path does, with its residual."""
    from mrhyde_tpu.assembly.assembler import TimeCoeffs as JaxTC
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    cfg = thermal_cfg(4)
    for k, v in cfg_patch.items():
        cfg[k] = dict(cfg.get(k, {}), **v)
    pj, pt = both_problems(cfg)
    assert pt.assembler.fused_provider() is None
    rng = np.random.RandomState(2)
    u, bt = rng.randn(pt.n_dof), rng.randn(pt.n_dof)
    rj = pj.assembler.residual(jnp.asarray(u), JaxTC(
        1.0, jnp.zeros(pt.n_dof), 10.0, jnp.asarray(bt), 0.1, 0.1))
    rt = pt.assembler.residual(state_from_numpy(u, pt), TimeCoeffs(
        1.0, torch.zeros(pt.n_dof, dtype=torch.float64), 10.0,
        state_from_numpy(bt, pt), 0.1, 0.1))
    assert np.max(np.abs(state_to_numpy(rt) - np.asarray(rj))) <= \
        1e-12 * np.max(np.abs(np.asarray(rj)))


def test_default_device_is_the_card(monkeypatch, tmp_path):
    """With no device named, the entry points take the card; without
    one they raise rather than fall back to the CPU."""
    from mrhyde_tpu_torch import driver
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.runtime import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        Problem(thermal_cfg(4))
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(channel_cfg(4, 2)))
    with pytest.raises(RuntimeError):
        driver.main([str(deck)])
    assert resolve_device("cpu") == torch.device("cpu")
