"""Kernel times of two trees of this repository on one card, in turns.

    python tools/kernel_ab.py PARENT_DIR [--out DIR] [--phases P,...]

Runs kernel phases of each tree's own chip_smoke.py (by default 3, 3b
and 3c: `phase_kernels`, `phase_ns_kernels`, `phase_elem_kernels`;
`--phases` names others, such as `phase_ns_elem_kernels`) in a process
of its own, parent, change, change, parent, where the change is the tree
this script lives in and PARENT_DIR holds the other (an unpacked `git
archive` of the parent commit). Each tree builds its kernels into its
own `mrhyde_tpu_torch/ops/build/`. Each kernel is timed two ways: as the
tree's chip_smoke.py times it (`ms`: one launch between two CUDA events,
median of 20, so the wrapper's host time before the launch falls inside
the window), and over 20 launches back to back between two events
(`batched_ms`: median of 5 such batches, the wrapper's host time
overlapped by the kernels before it). The plain versions of phases 3b,
3c and 3e are not timed.
Writes each run's JSON lines to DIR/ab_<side>_<n>.txt and prints, for
every case, both sides' times and the change/parent ratio of the means,
and each run's max_abs_err against the plain version: equal on both
sides when the two trees' kernels give the same bits.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import json, statistics, sys, torch
import chip_smoke as cs
from mrhyde_tpu_torch.ops import _build
_build.load_library()
dev = torch.device("cuda", 0)
single = cs.cuda_ms


def batched_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


def both(fn, reps=20, warm=True):
    # a record's kernel is timed first, then its plain version (reps 5,
    # not timed here; phase 3 times it with the default, and it is)
    if reps != 20:
        return 0.0
    both.calls.append(batched_ms(fn))
    return single(fn)


def emit(rec):
    if "ms" in rec:
        rec["batched_ms"] = both.calls[0]
    both.calls.clear()
    print(json.dumps(rec), flush=True)


both.calls = []


cs.cuda_ms = both
cs.emit = emit
for phase in sys.argv[1].split(","):
    getattr(cs, phase)(dev)
"""


def _key(rec):
    return (rec["kernel"], rec["case"], rec.get("mesh", "p1"), rec["dtype"],
            tuple(rec["shape"]))


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("parent")
    ap.add_argument("--out", default="kernel_ab_out")
    ap.add_argument("--phases", default="phase_kernels,phase_ns_kernels,"
                    "phase_elem_kernels")
    args = ap.parse_args(argv)
    change = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    trees = {"parent": os.path.abspath(args.parent), "change": change}
    os.makedirs(args.out, exist_ok=True)
    runs = {"parent": [], "change": []}
    for n, side in enumerate(("parent", "change", "change", "parent")):
        out = subprocess.run([sys.executable, "-c", _CHILD, args.phases],
                             cwd=trees[side], capture_output=True,
                             text=True, check=True)
        with open(os.path.join(args.out, f"ab_{side}_{n}.txt"), "w") as f:
            f.write(out.stdout)
        runs[side].append({_key(r): r for r in map(
            json.loads, out.stdout.splitlines()) if "ms" in r})
    for key in runs["parent"][0]:
        row = {"case": list(key)}
        for metric in ("ms", "batched_ms"):
            p = [r[key][metric] for r in runs["parent"]]
            c = [r[key][metric] for r in runs["change"]]
            row[metric] = {"parent": p, "change": c,
                           "ratio": statistics.mean(c) / statistics.mean(p)}
        row["max_abs_err"] = {side: [r[key]["max_abs_err"]
                                     for r in runs[side]]
                              for side in ("parent", "change")}
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
