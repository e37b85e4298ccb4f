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
every case both trees run (the cases of one side only are listed last),
both sides' times and the change/parent ratio of the means,
each run's max_abs_err against the plain version, and each run's sha256
of the kernel's outputs (`out_sha`, the bytes of every tensor the
timed call returns, on the phase's seeded inputs) with `same_bits`: true
when all four runs' outputs are equal to the bit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

_CHILD = r"""
import hashlib, json, statistics, sys, torch
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


def digest(out):
    h = hashlib.sha256()
    for o in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(o, torch.Tensor):
            h.update(o.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def both(fn, reps=20, warm=True):
    # a record's kernel is timed first, then its plain version (reps 5,
    # not timed here; phase 3 times it with the default, and it is)
    if reps != 20:
        return 0.0
    both.shas.append(digest(fn()))
    both.calls.append(batched_ms(fn))
    return single(fn)


def emit(rec):
    if "ms" in rec:
        rec["batched_ms"] = both.calls[0]
        rec["out_sha"] = both.shas[0]
    both.calls.clear()
    both.shas.clear()
    print(json.dumps(rec), flush=True)


both.calls = []
both.shas = []


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
    shared = [k for k in runs["parent"][0] if k in runs["change"][0]]
    for key in shared:
        row = {"case": list(key)}
        for metric in ("ms", "batched_ms"):
            p = [r[key][metric] for r in runs["parent"]]
            c = [r[key][metric] for r in runs["change"]]
            row[metric] = {"parent": p, "change": c,
                           "ratio": statistics.mean(c) / statistics.mean(p)}
        row["max_abs_err"] = {side: [r[key]["max_abs_err"]
                                     for r in runs[side]]
                              for side in ("parent", "change")}
        shas = {side: [r[key]["out_sha"] for r in runs[side]]
                for side in ("parent", "change")}
        row["out_sha"] = shas
        row["same_bits"] = len(set(shas["parent"] + shas["change"])) == 1
        print(json.dumps(row), flush=True)
    only = {side: [list(k) for k in runs[side][0] if k not in shared]
            for side in ("parent", "change")}
    print(json.dumps({"cases_on_one_side_only": only}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
