"""ProcessGroupComm (`parallel/comm.py`): 2 gloo ranks, one shard each,
on the CPU in f64, equal StackedComm at 2 shards in one process to
1e-12: the DOF scheme's deck run, residual and Newton-CG step, a
transient deck, and the multiscale gold deck under both schemes (the
element-sharded one spreading its fine solves over the ranks). Each rank
is a subprocess running tests/torch_dist_worker.py (which imports no
JAX), joined through a file:// rendezvous under tmp_path."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import torch_dist_worker as worker

torch.set_num_threads(1)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RTOL = 1e-12


def _ranks(case, tmp_path, world=2, timeout=300):
    """Runs the case on `world` gloo ranks; rank 0's results."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, HERE, os.environ.get("PYTHONPATH", "")]))
    init, out = tmp_path / "rendezvous", tmp_path / "out.json"
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_dist_worker.py"),
         str(r), str(world), str(init), str(out), case], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    try:
        for p in procs:
            _o, e = p.communicate(timeout=timeout)
            errs.append(e)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert all(p.returncode == 0 for p in procs), errs
    return json.loads(out.read_text())


def _close(a, b, rtol=RTOL):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert a.shape == b.shape
    assert np.max(np.abs(a - b)) <= rtol * max(np.max(np.abs(b)), 1e-300)


@pytest.mark.parametrize("case", ["dof", "transient", "replicated",
                                  "ms_dof"])
def test_two_gloo_ranks_equal_stacked_shards(case, tmp_path):
    """The case over 2 gloo ranks equals it over StackedComm(2): every
    norm, the solution, and for "dof" the sharded residual and Newton-CG
    step at a seeded state; the Krylov counts are the same."""
    from mrhyde_tpu_torch.parallel.comm import StackedComm
    got = _ranks(case, tmp_path)
    want = worker.run_case(case, StackedComm(2))
    assert [n[:3] for n in got["norms"]] == [n[:3] for n in want["norms"]]
    _close([n[3] for n in got["norms"]], [n[3] for n in want["norms"]])
    _close(got["u"], want["u"])
    assert got["counts"] == want["counts"]
    if case == "dof":
        _close(got["residual"], want["residual"])
        _close(got["step"], want["step"])
        assert abs(got["rnorm"] - want["rnorm"]) <= RTOL * want["rnorm"]
