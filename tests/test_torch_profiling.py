"""The port's timers and profiling (mrhyde_tpu_torch/utils/profiling.py),
modelled on the JAX package's tests/test_aux_tools.py: the report's
format against the JAX package's, the CLI's `--profile` flag and the
deck's `profile: true` key (the timer report printed and written to
mrhyde_tpu.profile, with the CLI's set-up and run timers, as the JAX
CLI does, and the program's own spans and counters), and a torch.profiler
trace on the CPU. The spans: totals, calls and the ring per name,
nesting, no profiler range without a recording profiler, the program's
ranges nested in a trace of a forward; the host-sync counter against the
count its Newton, GMRES and CG iterations imply."""

import json
import math

import pytest
import torch
import yaml

from mrhyde_tpu_torch import driver
from mrhyde_tpu_torch.utils import profiling
from mrhyde_tpu_torch.utils.profiling import (reset_timers, timed,
                                              timer_report, trace)
from torch_port_utils import thermal_cfg

# a 2D thermal deck on GMRES with the geometric multigrid, its initial
# condition L2-projected (by CG above 6,000 DOFs)
MG_SOLVER = {"Belos solver": "Block GMRES",
             "preconditioner variant": "multigrid"}


def mg_cfg(nx):
    cfg = thermal_cfg(nx, solver=MG_SOLVER)
    cfg["Physics"]["Initial conditions"] = {"e": "x*y"}
    return cfg

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
    assert {"driver::run", "driver::setup", "driver::total",
            "problem::discretization", "forward::initial_state",
            "newton::step"} <= set(names)
    assert all(len(ln.split(", ")) == 3 for ln in written.splitlines())
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


def test_span_totals_calls_and_ring():
    reset_timers()
    for _ in range(profiling.RING + 10):
        with timed("unit"):
            pass
    with timed("other"):
        sum(range(1000))
    total, calls, ring = profiling.span_stats("unit")
    assert calls == profiling.RING + 10
    assert len(ring) == profiling.RING and min(ring) >= 0.0
    assert total >= sum(ring) and total < 1.0
    total, calls, ring = profiling.span_stats("other")
    assert calls == 1 and ring == [total] and total > 0.0
    assert profiling.span_stats("never") is None
    profiling.count("c", 3)
    profiling.count("c")
    assert profiling.counter("c") == 4 and profiling.counter("none") == 0
    assert profiling.host_value(torch.tensor(2.5)) == 2.5
    assert profiling.host_value(torch.tensor([1.0, 2.0])) == [1.0, 2.0]
    assert profiling.counter("host_syncs") == 2
    lines = timer_report().splitlines()
    assert lines[1:] == [lines[1], lines[2], "c, 4, 2", "host_syncs, 2, 2"]
    assert [ln.split(", ")[0] for ln in lines[1:3]] == ["other", "unit"]
    reset_timers()


def test_spans_nest():
    reset_timers()
    with timed("outer"):
        for _ in range(3):
            with timed("inner"):
                sum(range(10000))
    outer, n_outer, _ = profiling.span_stats("outer")
    inner, n_inner, ring = profiling.span_stats("inner")
    assert (n_outer, n_inner) == (1, 3)
    assert outer >= inner == pytest.approx(sum(ring))
    reset_timers()


def test_no_profiler_range_without_a_recording_profiler(monkeypatch):
    opened = []
    real = profiling._record_function

    def spy(name):
        opened.append(name)
        return real(name)
    monkeypatch.setattr(profiling, "_record_function", spy)
    for _ in range(5):
        with timed("quiet"):
            pass
    assert opened == []
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with timed("loud", "loud#7"):
            pass
    with timed("quiet"):
        pass
    assert opened == ["mrhyde::loud#7"]
    assert profiling.span_stats("loud")[1] == 1


def _ranges(prof):
    """[(start, end, name)] of the program's ranges on the host."""
    cpu = torch.autograd.DeviceType.CPU
    return sorted((e.start_ns(), e.end_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if e.device_type() == cpu
                  and e.name().startswith(profiling.PREFIX))


def test_program_ranges_nest_in_a_cpu_trace(tmp_path):
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(mg_cfg(80), device="cpu")
    p.forward()
    with trace(str(tmp_path / "tr")) as prof:
        p.forward()
    ranges = _ranges(prof)
    names = {n.split("#")[0] for _, _, n in ranges}
    want = {"forward", "forward::initial_state", "initial_state::mass",
            "initial_state::rhs", "initial_state::solve", "newton::step",
            "newton::line_search", "assembly", "assembly::coefficients",
            "assembly::kernel", "assembly::jacobian", "linear::solve",
            "krylov::cycle", "mg::setup", "mg::vcycle", "mg::level0",
            "mg::coarse", "forward::record"}
    assert want <= {n[len(profiling.PREFIX):] for n in names}
    forwards = [r for r in ranges if r[2].startswith("mrhyde::forward#")]
    assert len(forwards) == 1
    f0, f1, _ = forwards[0]
    assert all(f0 <= s and t <= f1 for s, t, _ in ranges)
    # ranges of one thread nest: none overlaps another in part
    for i, (s, t, n) in enumerate(ranges):
        for s2, t2, n2 in ranges[i + 1:]:
            if s2 >= t:
                break
            assert t2 <= t, (n, n2)

    def inside(child, parent):
        outer = [(s, t) for s, t, n in ranges if n == "mrhyde::" + parent]
        kids = [(s, t) for s, t, n in ranges if n == "mrhyde::" + child]
        assert kids
        return all(any(a <= s and t <= b for a, b in outer)
                   for s, t in kids)
    assert inside("mg::level1", "mg::level0")
    assert inside("mg::coarse", "mg::level1")
    assert inside("mg::level0", "mg::vcycle")
    assert inside("mg::vcycle", "linear::solve")
    assert inside("krylov::cycle", "linear::solve")
    assert inside("krylov::cycle", "newton::step")
    assert inside("assembly::kernel", "assembly")
    assert inside("assembly", "newton::step")
    assert inside("initial_state::solve", "forward::initial_state")
    assert inside("krylov::cg", "initial_state::solve")
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert any(e.get("name", "").startswith("mrhyde::mg::vcycle")
               for e in events["traceEvents"])


def test_host_syncs_are_the_count_the_iterations_imply():
    """One Newton step of a linear deck: a norm per step and one at
    convergence, one line-search residual (the full step is taken);
    GMRES: ||b||, the first residual, per restart cycle its beta and per
    Arnoldi step its column; the projection's CG (6,561 DOFs): b.b, the
    stopping test before each step and after the last, then the solve's
    two residual norms."""
    from mrhyde_tpu_torch.problem import Problem
    p = Problem(mg_cfg(80), device="cpu")
    assert p.n_dof > 6000 and p._proj_method() == "cg"
    seen = []
    for _ in range(2):
        cycles = profiling.span_stats("krylov::cycle")
        cycles = 0 if cycles is None else cycles[1]
        cg = profiling.counter("krylov::cg_iters")
        res = p.forward()
        c = res.counts
        cycles = profiling.span_stats("krylov::cycle")[1] - cycles
        cg = profiling.counter("krylov::cg_iters") - cg
        n = c["newton_iters"]
        assert n == 1 and res.newton.converged and cg > 0
        assert cycles == math.ceil(c["linear_iters"] / 40)
        want = (n + 1) + n + (2 * n + cycles + c["linear_iters"]) \
            + (1 + cg + 1 + 2)
        assert c["host_syncs"] == want
        seen.append(c)
    assert seen[0] == seen[1]
