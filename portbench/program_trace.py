"""The program's own spans and counters, as the per-layer metrics read
them, and a device trace reduced by the program's profiler ranges.

The port keeps them in `mrhyde_tpu_torch/utils/profiling.py`: per span
name its host seconds, its calls and a ring of its last durations; integer
counters; and, while a torch profiler records, a range "mrhyde::<span>"
around each span (the forward's carries its ordinal, "mrhyde::forward#3").
A reader gets None where there is nothing to read (a program without the
span or the counter, a run without a device trace), never an error.

Device time goes to a program range by launch: a kernel, copy or set
counts for a range when the runtime call that launched it (the host event
with its correlation id: cudaLaunchKernel and the like) started inside the
range, however late the card ran it. Program spans do not synchronize, so
overlap in time would be wrong.

    python3 portbench/program_trace.py --workload <cell> --seed <n> \
        --seconds <s> [--cost <requests>]

runs the cell traced, as `run.py --trace 1` does, and prints one JSON
line: the per-layer metrics, the profiled slice's device-idle seconds by
the innermost program span open on the host, the program's device-side
range mirrors and whether each is a user annotation, and spans per
forward. With --cost it then times that many requests without and with a
recording profiler, alternately (the cost of tracing on).
"""

from __future__ import annotations

import bisect
import re
import statistics
from collections import defaultdict
from typing import NamedTuple

PREFIX = "mrhyde::"
OUTSIDE = "outside"
# host events of the CUDA runtime and driver (by kineto's activity type
# where this torch gives it, else by the API's name); device activity
RUNTIME = ("cuda_runtime", "cuda_driver")
RUNTIME_NAME = re.compile(r"cu(da)?[A-Z]")
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def _profiling():
    try:
        from mrhyde_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling


def _span(name):
    stats = getattr(_profiling(), "span_stats", None)
    return None if stats is None else stats(name)


def span_median_ms(name):
    """The median of the span's ring of durations, in ms."""
    st = _span(name)
    return None if st is None or not st[2] else \
        1e3 * statistics.median(st[2])


def span_total_s(name):
    """The span's total host seconds over the process."""
    st = _span(name)
    return None if st is None else st[0]


def mean_count(run, key):
    """The mean of ForwardResult.counts[key] over the window's requests."""
    vals = [r["counts"].get(key) for r in run.requests]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


# -- the device trace ----------------------------------------------------


class Event(NamedTuple):
    """A trace event: kind "range" (a program range on the host),
    "runtime" (a CUDA runtime or driver call), "device" (a kernel, copy
    or set on the card), "op" (any other host event) or "mirror" (a
    range's device-side annotation); times in ns."""
    kind: str
    name: str
    start: int
    end: int
    corr: int = 0
    linked: int = 0


def events_of(prof):
    """[Event] of a stopped torch.profiler, or [] without one."""
    if prof is None:
        return []
    import torch
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        act = str(e.activity_type()) if hasattr(e, "activity_type") \
            else None
        start = e.start_ns()
        end = e.end_ns() if hasattr(e, "end_ns") \
            else start + e.duration_ns()
        on_host = e.device_type() == cpu
        annotation = bool(e.is_user_annotation()) \
            if hasattr(e, "is_user_annotation") else False
        if on_host and name.startswith(PREFIX):
            kind = "range"
        elif not on_host and (annotation or act == "gpu_user_annotation"
                              or name.startswith(PREFIX)):
            kind = "mirror"
        elif on_host and not annotation and (
                act in RUNTIME if act is not None
                else RUNTIME_NAME.match(name) is not None):
            kind = "runtime"
        elif not on_host and (act in DEVICE if act is not None
                              else True):
            kind = "device"
        else:
            kind = "op"
        out.append(Event(kind, name, start, end, e.correlation_id(),
                         e.linked_correlation_id()))
    return out


def span_of(name):
    """A program range's span name: its name without the prefix and the
    forward's ordinal."""
    return name[len(PREFIX):].split("#")[0]


def launches(events):
    """[(launch time, device seconds)]: each device event with the start
    of the runtime call that launched it (else of the host op it is linked
    to)."""
    runtime = {e.corr: e.start for e in events if e.kind == "runtime"}
    ops = {e.corr: e.start for e in events if e.kind == "op"}
    out = []
    for e in events:
        if e.kind != "device":
            continue
        t = runtime.get(e.corr)
        if t is None:
            t = ops.get(e.linked)
        if t is not None:
            out.append((t, (e.end - e.start) * 1e-9))
    return out


def device_ms_per_range(events, span):
    """The device ms of the work launched inside the program's ranges of
    one span, per range; None without such a range in the trace."""
    ranges = sorted((e.start, e.end) for e in events
                    if e.kind == "range" and span_of(e.name) == span)
    if not ranges:
        return None
    starts = [s for s, _ in ranges]
    total = 0.0
    for t, secs in launches(events):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            total += secs
    return 1e3 * total / len(ranges)


def _busy(events, w0, w1):
    """The merged device-busy intervals inside [w0, w1]."""
    dev = sorted((max(e.start, w0), min(e.end, w1)) for e in events
                 if e.kind == "device" and e.end > w0 and e.start < w1
                 and e.end > e.start)
    merged = []
    for s, t in dev:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    return merged


def innermost_segments(events, w0, w1):
    """[(a, b, span)] covering [w0, w1]: the innermost program range open
    on the host over each piece, OUTSIDE where none is (ranges of one
    thread nest)."""
    ranges = sorted((e.start, e.end, span_of(e.name)) for e in events
                    if e.kind == "range" and e.end > w0 and e.start < w1)
    starts = [s for s, _, _ in ranges]
    points = sorted({w0, w1} | {p for s, t, _ in ranges for p in (s, t)
                                if w0 < p < w1})
    out = []
    for a, b in zip(points, points[1:]):
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid) - 1
        name = OUTSIDE
        while i >= 0:
            if ranges[i][1] >= mid:
                name = ranges[i][2]
                break
            i -= 1
        if out and out[-1][2] == name and out[-1][1] == a:
            out[-1] = (out[-1][0], b, name)
        else:
            out.append((a, b, name))
    return out


def idle_by_span(events, window=None):
    """{span: device-idle seconds} over the window (default: from the
    first to the last event): the time with no kernel, copy or set on the
    card, by the innermost program span open on the host."""
    if window is None:
        if not events:
            return {}
        window = (min(e.start for e in events), max(e.end for e in events))
    w0, w1 = window
    busy = _busy(events, w0, w1)
    gaps, last = [], w0
    for s, t in busy:
        if s > last:
            gaps.append((last, s))
        last = max(last, t)
    if w1 > last:
        gaps.append((last, w1))
    idle = defaultdict(float)
    segs = innermost_segments(events, w0, w1)
    seg_starts = [a for a, _, _ in segs]
    for a, b in gaps:
        i = max(bisect.bisect_right(seg_starts, a) - 1, 0)
        while i < len(segs) and segs[i][0] < b:
            lo, hi = max(a, segs[i][0]), min(b, segs[i][1])
            if hi > lo:
                idle[segs[i][2]] += (hi - lo) * 1e-9
            i += 1
    return dict(idle)


def run_events(run):
    """[Event] of a traced run's profiler, cached on the run."""
    tracer = getattr(run, "tracer", None)
    if tracer is None or getattr(tracer, "prof", None) is None:
        return []
    if getattr(run, "_program_events", None) is None:
        run._program_events = events_of(tracer.prof)
    return run._program_events


def run_device_ms(run, span):
    return device_ms_per_range(run_events(run), span)


# -- the command -----------------------------------------------------------


def _window(events):
    for e in events:
        if e.kind == "op" and e.name == "portbench::profiled":
            return e.start, e.end
    return None


def _cost(cell_name, seed, n, device):
    """Mean seconds of a request without and with a recording profiler,
    alternating one request each, after a warm-up request."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    from mrhyde_tpu_torch.interop import sample_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    from portbench import harness
    cell = harness.Cell(cell_name)
    problem = Problem(cell.deck, device=device, dtype=torch.float64)
    cuda = torch.device(device).type == "cuda"
    stream = harness.samples(cell.deck, seed, 1)

    def request():
        sample = next(stream)
        problem.param_manager.update(sample)
        res = problem.forward(pvec=sample_from_numpy(sample, problem))
        float(torch.linalg.norm(res.u))
        if cuda:
            torch.cuda.synchronize()

    request()
    times = {"off": [], "on": []}
    for _ in range(n):
        t0 = time.perf_counter()
        request()
        times["off"].append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU]
                     + [ProfilerActivity.CUDA] * cuda):
            t0 = time.perf_counter()
            request()
            times["on"].append(time.perf_counter() - t0)
    return {k: statistics.mean(v) for k, v in times.items()}


def main(argv=None):
    import argparse
    import json
    import time

    import torch

    from portbench import run as _env  # noqa: F401  (threads, caches)
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    kept = []

    class Kept(harness.Run):
        def __init__(self, cell):
            super().__init__(cell)
            kept.append(self)
    harness.Run = Kept
    result, _ = harness.run_cell(args.workload, args.seed, args.seconds,
                                 True, t_start=time.perf_counter(),
                                 device=args.device)
    run = kept[-1]
    evs = run_events(run)
    idle = idle_by_span(evs, _window(evs))
    raw = [] if run.tracer is None or run.tracer.prof is None else \
        list(run.tracer.prof.profiler.kineto_results.events())
    cpu = torch.autograd.DeviceType.CPU
    mirrors = [bool(getattr(e, "is_user_annotation", lambda: False)())
               for e in raw
               if e.device_type() != cpu and e.name().startswith(PREFIX)]
    prof = _profiling()
    calls = {n: prof.span_stats(n)[1] for n in prof._STATS}
    per_forward = sum(c for n, c in calls.items()
                      if not n.startswith(("problem::", "ops::", "mg::hier"))
                      ) / max(calls.get("forward", 1), 1)
    out = {"workload": args.workload, "seed": args.seed,
           "correct": result["correct"], "metrics": result["metrics"],
           "device": result["device"],
           "breakdown": result.get("breakdown"),
           "idle_by_program_span": dict(sorted(idle.items(),
                                               key=lambda kv: -kv[1])),
           "program_mirrors": len(mirrors),
           "program_mirrors_annotated": sum(mirrors),
           "program_in_device_ops": [
               n for n, _ in (result.get("breakdown") or {}).get(
                   "device_ops", []) if n.startswith(PREFIX)],
           "spans_per_forward": per_forward,
           "report": prof.timer_report().splitlines()}
    if args.cost:
        out["cost_s"] = _cost(args.workload, args.seed + 1, args.cost,
                              args.device)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    import os
    import sys
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    main()
