"""CPU tests of the readers of the program's own spans and counters
(portbench/program_trace.py): a traced run of a small deck reports them,
the device-trace readers read None without a device trace, and device
time goes to a program range by the launch of its work, matched through
the correlation ids, on a hand-made event list."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import harness  # noqa: E402
from portbench import program_trace as pt  # noqa: E402
from portbench.program_trace import Event  # noqa: E402

SMALL = {
    "thermal2d_uq.uq_steady_mg": {"Mesh": {"NX": 24, "NY": 24}},
    "ns_channel_p1.repeat_steady_direct": {"Mesh": {"NX": 20, "NY": 4}},
}
PROGRAM = ("initial_state_ms", "host_syncs", "discretization_s")
DEVICE = ("vcycle_device_ms", "dense_lu_ms")


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_traced_run_reports_the_programs_metrics(cell):
    from mrhyde_tpu_torch.utils import profiling
    profiling.reset_timers()
    r, _ = harness.run_cell(cell, 2 ** 31 + 901, 0.3, 1, device="cpu",
                            deck_over=SMALL[cell])
    assert r["correct"] is True
    names = {n for n, _ in harness.Cell(cell).metrics(True)}
    assert set(PROGRAM) <= names
    for name in PROGRAM:
        assert r["metrics"][name]["value"] > 0, name
    # one Newton step of the linear thermal deck, two of the channel's,
    # each with its norms: a few syncs, the same in every request
    assert 3 <= r["metrics"]["host_syncs"]["value"] <= 40
    for name in DEVICE:
        assert name not in r["metrics"]


def test_the_device_readers_read_none_without_a_trace():
    run = harness.Run(harness.Cell("thermal2d_uq.uq_steady_mg"))
    for name in DEVICE:
        assert harness.load_module("metrics", name).read(run) is None
    assert pt.device_ms_per_range([], "mg::vcycle") is None
    assert pt.idle_by_span([]) == {}


def _events():
    """Two V-cycle ranges inside a forward; launches inside and between
    them, one of whose kernels runs after its range closed."""
    return [
        Event("range", "mrhyde::forward#4", 0, 1000),
        Event("range", "mrhyde::mg::vcycle", 100, 200),
        Event("range", "mrhyde::mg::vcycle", 300, 400),
        Event("runtime", "cudaLaunchKernel", 150, 160, corr=1, linked=71),
        Event("runtime", "cudaLaunchKernel", 250, 255, corr=2, linked=72),
        Event("runtime", "cudaMemcpyAsync", 390, 395, corr=3, linked=73),
        Event("op", "aten::mul", 110, 120, corr=74),
        # runs after the first range closed: still the first range's
        Event("device", "k_late", 500, 600, corr=1, linked=71),
        Event("device", "k_between", 260, 280, corr=2, linked=72),
        Event("device", "Memcpy HtoD", 395, 455, corr=3, linked=73),
        # no runtime event: found through the op it is linked to
        Event("device", "k_linked", 700, 740, corr=9, linked=74),
        Event("mirror", "mrhyde::mg::vcycle", 500, 600),
    ]


def test_device_time_goes_to_the_range_that_launched_it():
    evs = _events()
    # (100 + 60 + 40) ns over two ranges
    assert pt.device_ms_per_range(evs, "mg::vcycle") == pytest.approx(
        200e-9 * 1e3 / 2)
    # the forward launched all four: 220 ns in its one range
    assert pt.device_ms_per_range(evs, "forward") == pytest.approx(
        220e-9 * 1e3)
    assert pt.device_ms_per_range(evs, "linear::lu") is None


def test_idle_goes_to_the_innermost_program_span():
    evs = _events() + [Event("range", "mrhyde::newton::step", 1100, 1200)]
    idle = pt.idle_by_span(evs, (0, 1300))
    # busy: 260-280, 395-455, 500-600, 700-740; the mirror is no work
    assert idle == pytest.approx({
        "forward": 1e-9 * (100 + 60 + 20 + 45 + 100 + 260),
        "mg::vcycle": 1e-9 * (100 + 95),
        "newton::step": 1e-9 * 100,
        pt.OUTSIDE: 1e-9 * 200})
    assert sum(idle.values()) == pytest.approx(1e-9 * (1300 - 220))
    segs = pt.innermost_segments(evs, 0, 1300)
    assert segs[:3] == [(0, 100, "forward"), (100, 200, "mg::vcycle"),
                        (200, 300, "forward")]
