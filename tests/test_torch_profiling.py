"""The port's timers and profiling (mrhyde_tpu_torch/utils/profiling.py),
modelled on the JAX package's tests/test_aux_tools.py: the report's
format against the JAX package's, the CLI's `--profile` flag and the
deck's `profile: true` key (the timer report printed and written to
mrhyde_tpu.profile, with the CLI's set-up and run timers, as the JAX
CLI does), and a torch.profiler trace on the CPU."""

import json

import pytest
import torch
import yaml

from mrhyde_tpu_torch import driver
from mrhyde_tpu_torch.utils import profiling
from mrhyde_tpu_torch.utils.profiling import (reset_timers, timed,
                                              timer_report, trace)
from torch_port_utils import thermal_cfg

torch.set_num_threads(1)


def test_timers():
    reset_timers()
    with timed("unit"):
        pass
    with timed("unit"):
        pass
    with timed("b::other"):
        pass
    lines = timer_report().splitlines()
    assert lines[0] == "timer, total_seconds, calls"
    assert [ln.split(", ")[0] for ln in lines[1:]] == ["b::other", "unit"]
    assert lines[2].endswith(", 2")
    reset_timers()
    assert timer_report() == "timer, total_seconds, calls"


def test_report_format_matches_jax():
    from mrhyde_tpu.utils import profiling as jax_profiling
    reports = []
    for mod in (jax_profiling, profiling):
        mod.reset_timers()
        for name in ("driver::total", "driver::setup", "driver::run"):
            with mod.timed(name):
                pass
        reports.append([(ln.split(", ")[0], ln.split(", ")[-1])
                        for ln in mod.timer_report().splitlines()])
        mod.reset_timers()
    assert reports[0] == reports[1]


@pytest.mark.parametrize("how", ["flag", "deck key"])
def test_cli_profile_writes_the_timer_report(how, tmp_path, monkeypatch,
                                             capsys):
    cfg = thermal_cfg(4)
    if how == "deck key":
        cfg["profile"] = True
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(cfg))
    monkeypatch.chdir(tmp_path)
    reset_timers()
    argv = [str(deck), "--device", "cpu"]
    assert driver.main(argv + (["--profile"] if how == "flag" else [])) == 0
    out = capsys.readouterr().out
    written = (tmp_path / "mrhyde_tpu.profile").read_text()
    assert written in out
    names = [ln.split(", ")[0] for ln in written.splitlines()[1:]]
    assert names == ["driver::run", "driver::setup", "driver::total"]
    secs = {ln.split(", ")[0]: float(ln.split(", ")[1])
            for ln in written.splitlines()[1:]}
    assert secs["driver::total"] >= secs["driver::run"] > 0.0
    assert "L2 norm of the error for e" in out


def test_cli_without_profile_writes_nothing(tmp_path, monkeypatch, capsys):
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(thermal_cfg(4)))
    monkeypatch.chdir(tmp_path)
    assert driver.main([str(deck), "--device", "cpu"]) == 0
    assert "timer, total_seconds" not in capsys.readouterr().out
    assert not (tmp_path / "mrhyde_tpu.profile").exists()


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).add_(1.0)
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert events["traceEvents"]
    assert any("add_" in e.key for e in prof.key_averages())
