"""Timers and profiling.

The port of the JAX package's `mrhyde_tpu/utils/profiling.py`, the
analog of the reference's Teuchos::TimeMonitor counters (reference:
src/driver.cpp:41-42, 217-229 — `profile: true` writes MrHyDE.profile):
wall-clock accumulators per named scope, and `trace`, a torch.profiler
capture (the counterpart of the JAX package's jax.profiler trace).
"""

from __future__ import annotations

import os
import time
from collections import defaultdict
from contextlib import contextmanager

__all__ = ["timed", "timer_report", "reset_timers", "trace"]

_ACCUM = defaultdict(float)
_COUNT = defaultdict(int)


@contextmanager
def timed(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _ACCUM[name] += time.perf_counter() - t0
        _COUNT[name] += 1


def reset_timers():
    _ACCUM.clear()
    _COUNT.clear()


def timer_report() -> str:
    lines = ["timer, total_seconds, calls"]
    for name in sorted(_ACCUM):
        lines.append(f"{name}, {_ACCUM[name]:.6f}, {_COUNT[name]}")
    return "\n".join(lines)


@contextmanager
def trace(logdir: str = "mrhyde_tpu_trace"):
    """Capture a torch.profiler trace of the block: host activity, and
    the card's where torch sees one. Written as a Chrome trace,
    `logdir`/trace.json; yields the profiler (key_averages())."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
