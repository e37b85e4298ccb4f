"""Transient multiscale decks in mrhyde_tpu_torch against the JAX
package on the CPU in f64: synchronous subgrids under BWE and DIRK-3,3
(the fine history and stage weights in pvec["__ms"], each accepted stage
recorded, each step committed), and asynchronous subgrids with one fine
BWE substep per macro step (equal to the synchronous run) and with four
(the macro trace interpolated in time). Decks: chip_smoke.py's
multiscale_transient_deck at 4x4."""

import copy

import jax
import pytest
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import solve_both  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10


@pytest.mark.parametrize("tableau,refine", [("BWE", 1), ("DIRK-3,3", 1)])
def test_synchronous_subgrid_matches_jax(tableau, refine):
    """The error history at every step (macro L2 and Subgrid-L2) at
    1e-10: BWE 3 steps to t = 0.6, DIRK-3,3 (BDF 1, 4 fine Newton steps)
    2 steps to t = 0.5."""
    solver = {"number of steps": 3, "final time": 0.6}
    if tableau != "BWE":
        solver = {"number of steps": 2, "final time": 0.5,
                  "transient BDF order": 1,
                  "transient Butcher tableau": tableau,
                  "max nonlinear iters": 4}
    rj, rt, pt = solve_both(cs.multiscale_transient_deck(4, solver, refine),
                            rtol=RTOL)
    assert len(rt.error_history) == solver["number of steps"] + 1
    ms = pt.multiscale
    assert ms.fine_prev.shape == (16, 1, ms.n_fine_dof)
    # the committed fine state is the last step's: its L2 is the report's
    assert rt.errors[("Subgrid-L2", "e")] == ms.compute_errors(
        rt.u, rt.time)[("Subgrid-L2", "e")]


def _async_deck(substeps):
    return cs.multiscale_transient_deck(
        4, {"number of steps": 2, "final time": 0.4}, substeps=substeps)


def test_async_one_substep_equals_sync():
    """One fine BWE substep at the macro step, the trace interpolated to
    the step's end: the synchronous algorithm (1e-12)."""
    from mrhyde_tpu_torch.problem import Problem
    sync = Problem(cs.multiscale_transient_deck(
        4, {"number of steps": 2, "final time": 0.4}), device="cpu").run()
    asy = Problem(_async_deck(1), device="cpu").run()
    for (t1, e1), (t2, e2) in zip(sync.error_history, asy.error_history):
        assert t1 == t2
        for k, v in e1.items():
            assert abs(e2[k] - v) <= 1e-12 * abs(v) + 1e-14, (t1, k)


def test_async_four_substeps_match_jax():
    """Four fine substeps per macro step with the Lagrange-interpolated
    macro trace (reference subgridDtN_solver.cpp:339-442): 1e-10."""
    _rj, rt, pt = solve_both(copy.deepcopy(_async_deck(4)), rtol=RTOL)
    assert not pt.multiscale.sync and pt.multiscale.sub_steps == 4
