"""CLI driver: `mrhyde-tpu-torch input.yaml` (or `python -m
mrhyde_tpu_torch.driver input.yaml`).

Parse the input deck (the JAX package's YAML schema and split-deck
`<Sublist> input file` convention), build the problem on the chosen
device, run it and print the error report: the JAX CLI's lines, one per
norm and recorded time (every step of a transient deck).

  --device {cuda,cpu}   where to run (default: cuda; without a usable
                        card that raises, so a CPU run asks for cpu)
  --fp32                single precision (default: double)
  --profile             print the set-up and run timers and write them to
                        mrhyde_tpu.profile (as the deck's `profile: true`)
"""

from __future__ import annotations

import argparse
import os
import sys

__all__ = ["load_input_deck", "main"]

_SUBLISTS = ("Mesh", "Physics", "Discretization", "Solver", "Analysis",
             "Postprocess", "Parameters", "Functions", "Subgrid",
             "Aux Physics", "Aux Discretization")


def _load_yaml(path: str):
    """yaml.safe_load with the reference reader's indentation tolerance:
    Teuchos accepts stray odd-space indents (e.g. the WeakGalerkin_3D
    deck's 3-space ' Functions:' line); PyYAML does not, so on a parse
    error retry with odd leading indents rounded down to even."""
    import yaml
    text = open(path).read()
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        pass
    fixed = []
    for line in text.splitlines(keepends=True):
        ns = len(line) - len(line.lstrip(" "))
        if ns % 2 == 1 and line.strip():
            line = line[1:]
        fixed.append(line)
    try:
        return yaml.safe_load("".join(fixed))
    except yaml.YAMLError:
        pass
    # second fallback: a key over-indented relative to its SIBLING
    # scalar (e.g. '        ROL:' after '    write output: false' in
    # 2d_gradient_check_ms/input_rol2.yaml) dedents to the sibling's
    # level, its subtree shifting with it
    out, shift_from, shift_by = [], None, 0
    prev_indent = 0
    for line in fixed:
        s = line.strip()
        if not s or s.startswith("#"):
            out.append(line)
            continue
        ns = len(line) - len(line.lstrip(" "))
        if shift_from is not None:
            if ns >= shift_from:
                out.append(line[shift_by:])
                continue
            shift_from = None
        if (ns > prev_indent + 2 and out
                and out[-1].strip()
                and not out[-1].rstrip().endswith(":")):
            shift_by = ns - prev_indent
            shift_from = ns
            out.append(line[shift_by:])
            prev_indent = ns - shift_by
            continue
        out.append(line)
        prev_indent = ns
    return yaml.safe_load("".join(out))


def load_input_deck(path: str) -> dict:
    import yaml
    cfg = _load_yaml(path)
    # the reference wraps everything in an ANONYMOUS root
    if isinstance(cfg, dict) and set(cfg) == {"ANONYMOUS"}:
        cfg = cfg["ANONYMOUS"]
    base = os.path.dirname(os.path.abspath(path))
    cfg.setdefault("_deck_dir", base)
    for sub in _SUBLISTS:
        key = f"{sub} input file"
        if key in cfg:
            inc = os.path.join(base, cfg.pop(key))
            if not os.path.exists(inc):
                # the reference silently skips missing include files
                # (userInterface.hpp:160-163 ifstream fn.good() guard;
                # e.g. ODE/BDF3 names an input_mesh.yaml that is absent)
                continue
            extra = _load_yaml(inc)
            if isinstance(extra, dict) and set(extra) == {"ANONYMOUS"}:
                extra = extra["ANONYMOUS"]
            merged = extra.get(sub, extra) if isinstance(extra, dict) else {}
            cfg.setdefault(sub, {}).update(merged or {})
    return cfg


def main(argv=None):
    ap = argparse.ArgumentParser(prog="mrhyde-tpu-torch")
    ap.add_argument("deck")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--fp32", action="store_true")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args(argv)

    import torch
    from mrhyde_tpu_torch.problem import Problem
    from mrhyde_tpu_torch.utils.profiling import timed, timer_report

    cfg = load_input_deck(args.deck)
    with timed("driver::total"):
        with timed("driver::setup"):
            problem = Problem(cfg, device=args.device,
                              dtype=torch.float32 if args.fp32
                              else torch.float64)
        with timed("driver::run"):
            result = problem.run()
    if problem.compute_errors:
        print(result.report())
    if args.profile or cfg.get("profile", False):
        report = timer_report()
        print(report)
        with open("mrhyde_tpu.profile", "w") as f:
            f.write(report)
    if int(cfg.get("verbosity", 0)) > 0:
        print(f"n_dof = {problem.n_dof}, final time = {result.time}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
