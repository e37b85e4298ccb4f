"""The analysis modes of mrhyde_tpu_torch (`analysis/manager.py`,
`trust_region.py`, `uq.py`) against the JAX package on the CPU in f64:
the printed ROL trust-region tables of two decks (boundary and secant
steps; the Kelley-Sachs bounded model with a rejected step) with their
finite-difference check, counter for counter and value for value; UQ
samples (numpy draws and a user-defined sample file), responses and
moments; DCI's ratios and acceptances; the dry-run report; restart from
text dumps; and the CLI printing the tables and 'param i = ...'."""

import contextlib
import copy
import io
import re

import jax
import numpy as np
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import rol_cfg, thermal_cfg, uq_cfg  # noqa: E402

torch.set_num_threads(1)


def _run(cfg):
    """(JAX result, port result, JAX stdout, port stdout) of one deck."""
    from mrhyde_tpu.problem import make_problem as jmake
    from mrhyde_tpu_torch.problem import make_problem
    out = []
    for make, kw in ((jmake, {}), (make_problem, {"device": "cpu"})):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            res = make(copy.deepcopy(cfg), **kw).run()
        out.append((res, buf.getvalue()))
    return out[0][0], out[1][0], out[0][1], out[1][1]


_NUM = re.compile(r"[-+]?\d+\.\d+e[-+]\d+")


def assert_same_tables(text_t, text_j, rtol=1e-6):
    """Line for line: the same words and integer counters, and every
    printed float to rtol (or to 1e-12 of the column's scale)."""
    lt, lj = text_t.splitlines(), text_j.splitlines()
    assert len(lt) == len(lj) and len(lt) > 5
    for a, b in zip(lt, lj):
        assert _NUM.sub("#", a) == _NUM.sub("#", b)
        fa = [float(x) for x in _NUM.findall(a)]
        fb = [float(x) for x in _NUM.findall(b)]
        np.testing.assert_allclose(fa, fb, rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("bounded", [False, True])
def test_rol_tables_match_jax(bounded):
    rj, rt, tj, tt = _run(rol_cfg(bounded=bounded, iters=5 if bounded
                                  else 3, fd_check=not bounded))
    assert_same_tables(tt, tj)
    assert ("Kelley-Sachs" in tt) == bounded
    assert ("flagCG" in tt) and ("FD approx" in tt) == (not bounded)
    rows = [ln.split() for ln in tt.splitlines()
            if re.match(r"^  \d+ ", ln) and len(ln.split()) == 10]
    flags = {(r[7], r[9]) for r in rows}
    # boundary steps (flagCG 3) on both, a rejected step on the bounded
    assert any(f[1] == "3" for f in flags)
    if bounded:
        assert any(f[0] != "0" for f in flags)
    assert rt.iterations == rj.iterations and rt.status == rj.status
    np.testing.assert_allclose(rt.x, rj.x, rtol=1e-9)
    assert [ln for ln in tt.splitlines() if ln.startswith("param ")] == \
        [ln for ln in tj.splitlines() if ln.startswith("param ")]


@pytest.mark.parametrize("analysis", ["UQ", "DCI"])
def test_uq_and_dci_match_jax(analysis):
    rj, rt, _tj, _tt = _run(uq_cfg(analysis=analysis))
    for k in rj["samples"]:
        np.testing.assert_array_equal(rt["samples"][k], rj["samples"][k])
    np.testing.assert_allclose(rt["responses"], rj["responses"], rtol=1e-11)
    for k in ("mean", "variance"):
        np.testing.assert_allclose(rt["stats"][k], rj["stats"][k],
                                   rtol=1e-10)
    if analysis == "DCI":
        np.testing.assert_allclose(rt["dci"]["ratios"], rj["dci"]["ratios"],
                                   rtol=1e-9)
        np.testing.assert_array_equal(rt["dci"]["accepted"],
                                      rj["dci"]["accepted"])
        assert rt["dci"]["acceptance_rate"] == rj["dci"]["acceptance_rate"]


def test_user_defined_samples(tmp_path):
    """'use user defined' + 'source': the file's columns in stochastic
    declaration order, N rows N samples."""
    f = tmp_path / "samples.dat"
    np.savetxt(f, np.array([[1.5, 0.9], [1.25, 1.1], [1.9, 1.0]]))
    rj, rt, _tj, _tt = _run(uq_cfg(user_file=f))
    assert rt["responses"].shape == (3,)
    np.testing.assert_array_equal(rt["samples"]["kappa"], [1.5, 1.25, 1.9])
    np.testing.assert_allclose(rt["responses"], rj["responses"], rtol=1e-11)


def test_dry_run_report_matches_jax():
    cfg = thermal_cfg(4)
    cfg["Analysis"] = {"analysis type": "dry run"}
    rj, rt, tj, tt = _run(cfg)
    assert rt == rj and tt == tj
    assert "has completed the dry run" in rt


def test_restart_and_forward_adjoint(tmp_path, monkeypatch):
    """restart: the state and scalar-parameter text files, then the
    forward from that state (a transient deck from its start time); the
    forward+adjoint mode's objective and gradient."""
    monkeypatch.chdir(tmp_path)
    cfg = thermal_cfg(4, kappa="k0", source="amp*8*(pi*pi)*x*y")
    cfg["Physics"]["Initial conditions"] = {"e": "0.0"}
    cfg["Solver"] = {"solver": "transient", "final time": 0.3,
                     "number of steps": 2, "delta t": 0.1}
    cfg["Parameters"] = {
        "k0": {"type": "scalar", "value": 1.0, "usage": "active"},
        "amp": {"type": "scalar", "value": 1.0, "usage": "active"}}
    from mrhyde_tpu_torch.problem import Problem
    n = Problem(copy.deepcopy(cfg), device="cpu").n_dof
    np.savetxt("state.dat", 0.01 * np.sin(np.arange(n)))
    np.savetxt("params.dat", np.array([1.5, 0.5]))
    cfg["Analysis"] = {"analysis type": "restart", "Restart": {
        "mode": "forward", "start time": 0.1,
        "state file name": "state.dat",
        "scalar parameter file name": "params.dat"}}
    rj, rt, _tj, _tt = _run(cfg)
    assert rt.time == pytest.approx(rj.time) == pytest.approx(0.3)
    np.testing.assert_allclose(rt.u.numpy(), np.asarray(rj.u), rtol=1e-11,
                               atol=1e-15)
    cfg["Analysis"] = {"analysis type": "forward+adjoint"}
    cfg["Solver"].pop("delta t")
    cfg["Postprocess"]["Objective functions"] = {
        "r": {"type": "integrated response", "response": "e", "target": 0.1}}
    rj, rt, _tj, _tt = _run(cfg)
    assert abs(rt.objective - rj.objective) <= 1e-12 * abs(rj.objective)
    for k in rj.gradient:
        np.testing.assert_allclose(rt.gradient[k], rj.gradient[k],
                                   rtol=1e-10)


def test_cli_prints_the_tables(tmp_path, capsys):
    """The port's CLI on the CPU prints what AnalysisManager prints: the
    FD check, the trust-region table twice ('Write Final Parameters')
    and the final 'param i = ...' lines."""
    import yaml
    from mrhyde_tpu_torch.driver import main
    from mrhyde_tpu_torch.problem import make_problem
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump({"ANONYMOUS": rol_cfg(iters=2)}))
    assert main([str(deck), "--device", "cpu"]) == 0
    cli = capsys.readouterr().out
    make_problem(rol_cfg(iters=2), device="cpu").run()
    direct = capsys.readouterr().out
    assert cli == direct
    assert cli.count("Truncated CG Trust-Region Solver") == 2
    assert "param 0 = " in cli and "param 1 = " in cli
