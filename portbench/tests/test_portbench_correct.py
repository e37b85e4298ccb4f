"""CPU tests of how `correct` is decided: each configuration's plain
reference agrees with the port in float64 on small decks; the control,
the port's own float32 path, fails the comparison; and a run whose timed
path is broken underneath comes out not correct."""

import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench.tests.test_portbench_harness import SMALL  # noqa: E402

CELLS = sorted(SMALL)


def _run(cell, dtype=torch.float64, over=None, seconds=0.3):
    return harness.run_cell(cell, 2 ** 31 + 4242, seconds, 0, device="cpu",
                            dtype=dtype, deck_over=over or SMALL[cell])


@pytest.mark.parametrize("cell", CELLS)
def test_the_port_in_float64_is_correct(cell):
    result, checks = _run(cell)
    assert result["correct"] is True, checks
    assert result["attempted"] >= 1 and result["failed"] == 0


def test_the_multigrid_path_is_correct():
    """Past 4,000 DOFs the thermal deck takes GMRES + StructuredMG, its
    timed path on the card."""
    result, checks = _run("thermal2d_uq.uq_steady_mg",
                          over={"Mesh": {"NX": 72, "NY": 72}})
    assert result["correct"] is True, checks


# the channel's float32 residual grows with the mesh: under the deck's
# 1e-6 at 40 x 8 (6.4e-7), over it from 80 x 16 (1.6e-6)
CONTROL = dict(SMALL, **{"ns_channel_p1.repeat_steady_direct": {
    "Mesh": {"NX": 80, "NY": 16}}})


@pytest.mark.parametrize("cell", CELLS)
def test_the_float32_control_is_not_correct(cell):
    result, checks = _run(cell, dtype=torch.float32, over=CONTROL[cell])
    assert result["correct"] is False
    # the compared number itself fails, whatever the Newton solve says
    assert any(v > lim for _, v, lim in checks), checks


def _unchanged(res, problem):
    """A solve that returns its initial state."""
    res.u = problem.initial_state()
    return res


def _altered(res, problem):
    """An answer altered where it is produced: one free dof moved by a
    thousandth of the state's size."""
    u = res.u.clone()
    i = int(torch.nonzero(~problem.assembler.fixed)[len(u) // 7])
    u[i] += 1e-3 * float(torch.max(torch.abs(u)))
    res.u = u
    return res


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [_unchanged, _altered],
                         ids=["unchanged", "altered"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from mrhyde_tpu_torch.problem import Problem
    forward = Problem.forward

    def broken(self, *a, **k):
        return fault(forward(self, *a, **k), self)
    monkeypatch.setattr(Problem, "forward", broken)
    result, checks = _run(cell)
    assert result["correct"] is False, checks
