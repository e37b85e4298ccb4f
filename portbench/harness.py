"""One run of one benchmark cell of `mrhyde_tpu_torch` (the port).

Everything a cell is comes from files found by name: the cell's entry in
`BENCHMARK.json` names its configuration and its traffic; the
configuration is `configs/<config>.json` (the deck as it is run, its
source and what was changed) with its plain reference
`reference/<config>.py` and its frozen work counts
`roofline/<config>.py`; the traffic is `traffic/<traffic>.json` (the
deck's solver keys and the check); each metric is
`metrics/<metric>.py`, whose `read(run)` gives its value or None.

A run: set-up (imports, the CUDA context, `Problem(deck)`, whose first use
builds the port's kernels into the checkout, and one warm-up request),
then the window: requests back to back from one client, each a steady
solve through the port's UQ step (`param_manager.update(sample)`,
`sample_from_numpy`, `Problem.forward(pvec)`, the state's norm as the
response), started until `seconds` have passed. Then the device's peak
memory is read, the program freed, and a sample of the requests, drawn
from the seed with the slowest among them, judged by the configuration's
reference.
"""

from __future__ import annotations

import copy
import gc
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

from portbench.trace import Tracer

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "mrhyde_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(kind, name):
    """The module `<kind>/<name>.py` of the benchmark, by its path (a
    metric's name may hold dots)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge(base, over):
    """`base` with the nested dict `over` written into it."""
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merge(out.get(k, {}), v) if isinstance(v, dict) else v
    return out


class Cell:
    """A cell of BENCHMARK.json with its configuration and traffic."""

    def __init__(self, name, bench=None, deck_over=None):
        self.bench = bench or load_json(os.path.join(ROOT,
                                                     "BENCHMARK.json"))
        found = [w for w in self.bench["workloads"] if w["name"] == name]
        if not found:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = found[0]
        self.config_name = self.entry["config"]
        self.config = load_json(os.path.join(
            HERE, "configs", f"{self.config_name}.json"))
        self.traffic = load_json(os.path.join(
            HERE, "traffic", f"{self.entry['traffic']}.json"))
        self.deck = merge(merge(self.config["deck"],
                                self.traffic.get("deck", {})),
                          deck_over or {})
        if self.deck["Solver"].get("solver") == "transient":
            raise ValueError(f"{name}: a request is a steady solve; the "
                             "harness times no transient deck")

    def metrics(self, trace):
        """[(name, unit)] this cell reports: its end-to-end metrics, or
        with trace its per-layer ones (those listing it, or listing no
        cells and moving an end-to-end metric it reports)."""
        e2e = [m for m in self.bench["end_to_end"]
               if self.name in m.get("workloads", [self.name])]
        if not trace:
            return [(m["name"], m["unit"]) for m in e2e]
        moved = {m["name"] for m in e2e}
        return [(m["name"], m["unit"]) for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in moved)]


def samples(deck, seed, stream):
    """The deck's stochastic parameters, an endless stream of samples
    drawn from (seed, stream) as the port's UQ manager draws them: plain
    Monte Carlo, uniform between a parameter's min and max, Gaussian
    with its mean and variance. A deck with none yields {}."""
    specs = {n: p for n, p in (deck.get("Parameters") or {}).items()
             if isinstance(p, dict) and p.get("usage") == "stochastic"}
    rng = np.random.default_rng([int(seed) % 2 ** 63, stream])
    while True:
        out = {}
        for n, p in specs.items():
            kind = p.get("distribution", "uniform").lower()
            if kind == "uniform":
                out[n] = float(rng.uniform(p["min"], p["max"]))
            elif kind == "gaussian":
                out[n] = float(rng.normal(p["mean"],
                                          np.sqrt(p["variance"])))
            else:
                raise ValueError(f"{n}: no {kind!r} distribution")
        yield out


def log(line):
    print(line, file=sys.stderr, flush=True)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Run:
    """What a run measured, as the metric readers see it."""

    def __init__(self, cell):
        self.cell = cell
        self.deck = cell.deck
        self.requests = []      # [{"seconds", "counts"}]
        self.window_s = 0.0
        self.setup_s = 0.0
        self.problem_setup_s = 0.0
        self.tracer = None
        self.profile = None
        self.device_kind = None
        self.peaks = load_json(os.path.join(HERE, "peaks.json"))

    def mean_span_ms(self, name):
        """The mean host span `name` in ms, or None without one."""
        spans = [] if self.tracer is None else self.tracer.host(name)
        return 1e3 * sum(spans) / len(spans) if spans else None

    def roofline_pct(self):
        """The least time of one res_and_jac at the peaks of this card,
        over the mean device time of the kernels inside the traced
        assembly spans, in %; None without them."""
        prof = self.profile
        peak = self.peaks.get(self.device_kind or "")
        if not prof or not prof["assembly_device_s"] or peak is None:
            return None
        nbytes, nflops = load_module("roofline", self.cell.config_name) \
            .work(self.deck)
        least = max(nbytes / peak["hbm_bytes_per_s"],
                    nflops / peak["flops_per_s"]["float64"])
        asm = prof["assembly_device_s"]
        return 100.0 * least * len(asm) / sum(asm)


def run_cell(name, seed, seconds, trace, *, t_start=None, device="cuda",
             dtype=torch.float64, deck_over=None):
    """(result, checks): the contract's last line as a dict, and
    [(name, value, limit)] of the numbers compared. device, dtype and
    deck_over are for the tests and the control only: the CPU, the
    port's float32 path, a smaller deck."""
    t_start = time.perf_counter() if t_start is None else t_start
    cell = Cell(name, deck_over=deck_over)
    cuda = torch.device(device).type == "cuda"
    phases = {"imports": time.perf_counter() - t_start}
    if cuda:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    from mrhyde_tpu_torch.interop import sample_from_numpy
    from mrhyde_tpu_torch.problem import Problem

    def sync():
        if cuda:
            torch.cuda.synchronize()

    run = Run(cell)
    t0 = time.perf_counter()
    phases["context"] = t0 - t_start - phases["imports"]
    problem = Problem(cell.deck, device=device, dtype=dtype)
    sync()
    run.problem_setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()

    def request(sample):
        """The port's UQ step (AnalysisManager.uq_solve's forward_sample)
        and its response without an objective, the state's norm."""
        problem.param_manager.update(sample)
        pvec = sample_from_numpy(sample, problem)
        res = problem.forward(pvec=pvec)
        float(torch.linalg.norm(res.u))
        return res

    # warm-up: one request of the cell's shapes, on a sample of its own
    request(next(samples(cell.deck, seed, 0)))
    sync()
    phases["problem"] = run.problem_setup_s
    phases["warmup"] = time.perf_counter() - t0

    tracer = None
    if trace:
        tracer = run.tracer = Tracer(device)
        tracer.install()
        tracer.start_profile()
    states, drawn, failed = [], [], 0
    stream = samples(cell.deck, seed, 1)
    t_window = time.perf_counter()
    run.setup_s = t_window - t_start
    log("portbench: set-up " + ", ".join(
        f"{k} {v:.3f} s" for k, v in phases.items()))
    t_end = t_window
    while time.perf_counter() - t_window < seconds:
        sample = next(stream)
        t0 = time.perf_counter()
        if tracer is not None:
            with tracer.span("request"):
                res = request(sample)
        else:
            res = request(sample)
        sync()
        t_end = time.perf_counter()
        failed += not res.newton.converged
        run.requests.append({"seconds": t_end - t0,
                             "counts": dict(res.counts)})
        states.append(res.u.detach().clone())
        drawn.append(sample)
        mem = [torch.cuda.memory_allocated() / 2 ** 30,
               torch.cuda.memory_reserved() / 2 ** 30] if cuda else [0, 0]
        log(f"portbench: request {len(states)} "
            + " ".join(f"{k} {v:.4g}" for k, v in sample.items())
            + f" {t_end - t0:.4f} s {dict(res.counts)} "
            f"converged {res.newton.converged} allocated {mem[0]:.3f} "
            f"reserved {mem[1]:.3f} GiB")
        del res
    run.window_s = t_end - t_window
    if tracer is not None:
        tracer.uninstall()
        run.profile = tracer.summary()
    peak = int(torch.cuda.max_memory_allocated()) if cuda else 0
    run.device_kind = torch.cuda.get_device_name() if cuda else "cpu"

    # the check: a sample drawn from the seed, with the slowest request
    n = len(states)
    rng = np.random.default_rng([int(seed) % 2 ** 63, 2])
    want = int(cell.traffic["check"]["requests"])
    pick = set(rng.choice(n, size=min(want, n), replace=False).tolist()) \
        if n else set()
    if n:
        pick.add(int(np.argmax([r["seconds"] for r in run.requests])))
    checked = [(drawn[i], states[i]) for i in sorted(pick)]
    del problem, states
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref = load_module("reference", cell.config_name)
    got = ref.judge(cell.deck, checked, device)
    limits = cell.traffic["check"]["limits"]
    checks = [(k, float(got[k]), limits.get(k)) for k in sorted(got)]
    correct = bool(n) and failed == 0 and all(
        lim is not None and v <= lim for _, v, lim in checks)

    metrics = {}
    for mname, unit in cell.metrics(trace):
        value = load_module("metrics", mname).read(run)
        if value is not None:
            metrics[mname] = {"value": float(value), "unit": unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": run.device_kind,
           "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev}
    if run.profile is not None:
        dev["busy_s"] = run.profile["busy_s"]
        dev["window_s"] = run.profile["window_s"]
        result["breakdown"] = {"device_ops": run.profile["device_ops"],
                               "idle_gaps": run.profile["idle_gaps"]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, v, lim in checks}
    log(f"portbench: {name} seed {seed}: {n} requests in "
        f"{run.window_s:.3f} s, set-up {run.setup_s:.3f} s, peak "
        f"{peak / 2 ** 30:.3f} GiB, failed {failed}")
    return result, checks


def main(args, t_start):
    """The command line's run: exits 3 without the card the cell asks
    for, 4 where a forbidden package was loaded, else prints the result
    as the last line of standard output and the compared numbers as the
    last lines of standard error."""
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    chips = entry[0]["chips"] if entry else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result, checks = run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {', '.join(bad)}",
              file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    for k, v, lim in checks:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0
