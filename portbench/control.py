"""The control of `correct`: a cell run on the port's own float32 path
(`Problem(..., dtype=torch.float32)`), the nearest precision below the
decks' float64, judged by the same comparison as every run.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \
        --seconds <s>

prints, for each seed, one JSON line with the numbers compared and their
limits; every one of them should come out not correct.
"""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None):
    import argparse
    # the command's environment: few host threads, caches in the checkout
    from portbench import run  # noqa: F401
    from portbench import harness
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=1.0)
    args = p.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        result, checks = harness.run_cell(args.workload, seed, args.seconds,
                                          False, dtype=torch.float32)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": result["correct"],
                          "attempted": result["attempted"],
                          "failed": result["failed"],
                          "checks": result["checks"]}), flush=True)


if __name__ == "__main__":
    main()
