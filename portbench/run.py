"""The benchmark of mrhyde_tpu_torch, the PyTorch and CUDA port.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of BENCHMARK.json on this machine's card and prints one JSON
line (see portbench/harness.py). Set-up counts from this file's first
line. Kernel builds and caches stay inside the checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# few host threads, for steady runs; caches at fixed paths in the checkout
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "2"
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
    ROOT, "portbench", ".cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "portbench", ".cache",
                                              "triton")
sys.path.insert(0, ROOT)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


if __name__ == "__main__":
    args = parse()
    from portbench import harness
    sys.exit(harness.main(args, T_START))
