"""Timers, counters and profiling: the port's one tracing system.

The port of the JAX package's `mrhyde_tpu/utils/profiling.py`, the
analog of the reference's Teuchos::TimeMonitor counters (reference:
src/driver.cpp:41-42, 217-229 — `profile: true` writes MrHyDE.profile).

`timed(name)` is a span. Always, it adds its host time
(`time.perf_counter_ns`) and one call to the name's totals, and its
duration to the name's ring of the last `RING` durations (a median over
a long study, in flat memory). While a torch profiler records, and only
then, it also opens the profiler range "mrhyde::<name>" (or
"mrhyde::<label>"), so the program's spans sit on the kernels' clock in
the trace: the CUDA runtime calls made inside a range are its launches.
A span never synchronizes the card: its host time is the enqueue time of
its work.

`count(name, n)` adds to an integer counter. `host_value(t)` is the one
way the solvers read a device value on the host: it counts the counter
`host_syncs` and returns `t.tolist()`.

`timer_report()` prints the spans, then the counters, in the reference's
three columns (a counter's total in the second, its increments in the
third); `trace()` captures a torch.profiler timeline of a block, the
program's ranges with the kernels.
"""

from __future__ import annotations

import functools
import os
import time
from collections import defaultdict, deque
from contextlib import contextmanager

import torch
import torch.autograd.profiler as _autograd_profiler

__all__ = ["timed", "count", "host_value", "timer_report", "reset_timers",
           "span_stats", "counter", "trace", "PREFIX", "RING"]

PREFIX = "mrhyde::"
RING = 1024

_ns = time.perf_counter_ns
_record_function = _autograd_profiler.record_function


class _Stat:
    __slots__ = ("total_ns", "calls", "ring")

    def __init__(self):
        self.total_ns = 0
        self.calls = 0
        self.ring = deque(maxlen=RING)


_STATS: dict[str, _Stat] = {}
_COUNTERS = defaultdict(int)
_COUNTER_CALLS = defaultdict(int)


class timed:
    """with timed(name): ... — a span (the module docstring); as
    @timed(name), the span around each call of a function. `label`, when
    given, names the profiler range in place of `name` (the forward's
    ordinal)."""

    __slots__ = ("name", "label", "_t0", "_range")

    def __init__(self, name: str, label: str | None = None):
        self.name = name
        self.label = label

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._range = _record_function(
                PREFIX + (self.label or self.name))
            self._range.__enter__()
        else:
            self._range = None
        self._t0 = _ns()
        return self

    def __exit__(self, *exc):
        dt = _ns() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
        st = _STATS.get(self.name)
        if st is None:
            st = _STATS[self.name] = _Stat()
        st.total_ns += dt
        st.calls += 1
        st.ring.append(dt)
        return False

    def __call__(self, fn):
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with timed(name):
                return fn(*args, **kwargs)
        return spanned


def count(name: str, n: int = 1):
    _COUNTERS[name] += n
    _COUNTER_CALLS[name] += 1


def host_value(t):
    """t.tolist() (a Python number for a 0-d tensor), counted as one host
    sync: the host waits for the card's queue up to t."""
    _COUNTERS["host_syncs"] += 1
    _COUNTER_CALLS["host_syncs"] += 1
    return t.tolist()


def counter(name: str) -> int:
    return _COUNTERS.get(name, 0)


def span_stats(name: str):
    """(total seconds, calls, [the ring's seconds]) of a span, or None
    where it never closed."""
    st = _STATS.get(name)
    if st is None:
        return None
    return st.total_ns * 1e-9, st.calls, [d * 1e-9 for d in st.ring]


def reset_timers():
    _STATS.clear()
    _COUNTERS.clear()
    _COUNTER_CALLS.clear()


def timer_report() -> str:
    lines = ["timer, total_seconds, calls"]
    for name in sorted(_STATS):
        st = _STATS[name]
        lines.append(f"{name}, {st.total_ns * 1e-9:.6f}, {st.calls}")
    for name in sorted(_COUNTERS):
        lines.append(f"{name}, {_COUNTERS[name]}, {_COUNTER_CALLS[name]}")
    return "\n".join(lines)


@contextmanager
def trace(logdir: str = "mrhyde_tpu_trace"):
    """Capture a torch.profiler trace of the block: host activity with the
    program's ranges, and the card's where torch sees one. Written as a
    Chrome trace, `logdir`/trace.json; yields the profiler
    (key_averages())."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
