"""The traced run's instruments: host spans around calls into the port's
layers, and one bounded `torch.profiler` pass.

Spans are the benchmark's own wrappers, installed only in a `--trace 1`
run and removed when its window closes: each synchronizes the card on
entry and on exit, so that its host time is its layer's own work, and
opens a `portbench::<name>` profiler range. They wrap

  assembly      `Assembler.res_and_jac` (residual and Jacobian)
  residual      `Assembler.residual` (the line search's residuals)
  linear_solve  the Newton solve's `solve_linear_info`
  mg_setup      `StructuredMG.preconditioner(J)` (the per-Jacobian set-up)
  vcycle        each call of the preconditioner that call returns

The profiler starts with the window and stops at the first span boundary
after `profile_seconds`, so that a trace of a window of Krylov
iterations stays some hundreds of thousands of events; spans that ran while it was on are marked, since
its overhead is in their times. Its events stay in memory: `summary`
reduces them to device busy time, idle time by the span open on the host,
the device time inside each assembly span and the device operations that
took most time.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict

import torch

PREFIX = "portbench::"


class Tracer:
    def __init__(self, device, profile_seconds=2.0):
        self.cuda = torch.device(device).type == "cuda"
        self.profile_seconds = profile_seconds
        # name -> [(seconds, profiled)]
        self.spans = defaultdict(list)
        self.prof = None
        self._range = None
        self._t0 = None
        self.profiled_s = 0.0
        self._undo = []

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    @contextlib.contextmanager
    def span(self, name):
        self._sync()
        profiled = self.prof is not None
        t0 = time.perf_counter()
        with torch.autograd.profiler.record_function(PREFIX + name):
            yield
            self._sync()
        self.spans[name].append((time.perf_counter() - t0, profiled))
        self.maybe_stop()

    # -- the profiler pass ----------------------------------------------

    def start_profile(self):
        if not self.cuda:
            return
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._range = torch.autograd.profiler.record_function(
            PREFIX + "profiled")
        self._range.__enter__()
        self._t0 = time.perf_counter()

    def maybe_stop(self, force=False):
        if self.prof is None or self._range is None:
            return
        if not force and time.perf_counter() - self._t0 < \
                self.profile_seconds:
            return
        self._sync()
        self._range.__exit__(None, None, None)
        self._range = None
        self.profiled_s = time.perf_counter() - self._t0
        self.prof.stop()

    # -- wrappers around the port's layers --------------------------------

    def install(self):
        from mrhyde_tpu_torch.assembly.assembler import Assembler
        from mrhyde_tpu_torch.solvers import nonlinear
        from mrhyde_tpu_torch.solvers.multigrid import StructuredMG
        tracer = self

        def around(owner, attr, name):
            orig = getattr(owner, attr)

            def wrapped(*a, **k):
                with tracer.span(name):
                    return orig(*a, **k)
            setattr(owner, attr, wrapped)
            self._undo.append((owner, attr, orig))

        around(Assembler, "res_and_jac", "assembly")
        around(Assembler, "residual", "residual")

        around(nonlinear, "solve_linear_info", "linear_solve")

        setup = StructuredMG.preconditioner

        def preconditioner(hier, J):
            with tracer.span("mg_setup"):
                M = setup(hier, J)

            def vcycle(v):
                with tracer.span("vcycle"):
                    return M(v)
            return vcycle
        StructuredMG.preconditioner = preconditioner
        self._undo.append((StructuredMG, "preconditioner", setup))

    def uninstall(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)
        self.maybe_stop(force=True)

    def host(self, name):
        """[seconds] of the spans `name` that ran while the profiler was
        off (all of them, where every one ran under it)."""
        rows = self.spans.get(name, [])
        return [s for s, p in rows if not p] or [s for s, _ in rows]

    # -- the trace's reduction -------------------------------------------

    def summary(self, top=10):
        """None without a device trace; else {"busy_s", "window_s",
        "assembly_device_s": [device seconds inside each assembly span],
        "device_ops": [[name, s]], "idle_gaps": [[span, s]]}."""
        if self.prof is None:
            return None
        dev, ann = [], []
        window = None
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            start, end = _interval(e)
            if name.startswith(PREFIX):
                if e.device_type() != torch.autograd.DeviceType.CPU:
                    continue
                if name == PREFIX + "profiled":
                    window = (start, end)
                else:
                    ann.append((start, end, name[len(PREFIX):]))
            elif e.device_type() == torch.autograd.DeviceType.CUDA \
                    and not _is_annotation(e) and end > start:
                dev.append((start, end, name))
        if window is None or not dev:
            return None
        w0, w1 = window
        dev = sorted((max(s, w0), min(t, w1), n) for s, t, n in dev
                     if t > w0 and s < w1)
        busy, gaps, cur_s, cur_e = 0, [], None, None
        last = w0
        for s, t, _ in dev:
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                gaps.append((last if cur_e is None else cur_e, s))
                cur_s, cur_e = s, t
            else:
                cur_e = max(cur_e, t)
        busy += cur_e - cur_s
        gaps.append((cur_e, w1))
        ops = defaultdict(float)
        for s, t, n in dev:
            ops[n[:120]] += (t - s) * 1e-9
        idle = defaultdict(float)
        ann.sort()
        ann_starts = [s for s, _, _ in ann]
        for a, b in gaps:
            if b > a:
                idle[_innermost(ann, ann_starts, (a + b) / 2)] += \
                    (b - a) * 1e-9
        starts = [s for s, _, _ in dev]
        asm = []
        for s, t, n in ann:
            if n != "assembly":
                continue
            i = bisect.bisect_left(starts, s)
            tot = 0
            while i < len(dev) and dev[i][0] < t:
                tot += min(dev[i][1], t) - dev[i][0]
                i += 1
            asm.append(tot * 1e-9)
        return {
            "busy_s": busy * 1e-9, "window_s": (w1 - w0) * 1e-9,
            "assembly_device_s": asm,
            "device_ops": [[n, s] for n, s in sorted(
                ops.items(), key=lambda kv: -kv[1])[:top]],
            "idle_gaps": [[n, s] for n, s in sorted(
                idle.items(), key=lambda kv: -kv[1])[:top]]}


def _interval(e):
    """(start, end) of a kineto event in ns, whichever accessors this
    torch has."""
    if hasattr(e, "start_ns"):
        s = e.start_ns()
        return s, (e.end_ns() if hasattr(e, "end_ns")
                   else s + e.duration_ns())
    s = e.start_us() * 1000
    return s, s + e.duration_us() * 1000


def _is_annotation(e):
    f = getattr(e, "is_user_annotation", None)
    return bool(f()) if f is not None else False


def _innermost(ann, starts, t):
    """The innermost span that holds time t, or "harness": spans of one
    thread nest, so it is the latest-starting one that has not ended."""
    i = bisect.bisect_right(starts, t) - 1
    while i >= 0:
        if ann[i][1] >= t:
            return ann[i][2]
        i -= 1
    return "harness"
