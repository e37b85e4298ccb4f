"""One rank of tests/test_torch_dist.py: a deck's sharded Newton solves
over a torch.distributed gloo process group (ProcessGroupComm, one shard
per rank), on the CPU in f64. It imports torch and mrhyde_tpu_torch
only, so the test can start it as a plain subprocess.

    python tests/torch_dist_worker.py RANK WORLD INIT_FILE OUT CASE

INIT_FILE is the file:// rendezvous (no ports); rank 0 writes the
case's results to OUT as JSON."""

import json
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def case_cfg(case):
    """The deck of a case: "dof" the thermal 12^2 deck and a DIRK-2,2
    transient twin under the DOF scheme, "replicated" the multiscale gold
    deck under the element-sharded scheme (its fine solves spread over
    the ranks), "ms_dof" the same deck under the DOF scheme."""
    import chip_smoke as cs
    from torch_port_utils import thermal_cfg
    if case == "dof":
        cfg = thermal_cfg(12)
        cfg["Solver"]["nonlinear TOL"] = 1e-12
        return cfg
    if case == "transient":
        cfg = cs.transient_deck(12, {
            "transient Butcher tableau": "DIRK-2,2", "final time": 0.1,
            "number of steps": 2, "nonlinear TOL": 1e-12,
            "Belos solver": "CG", "max linear iters": 60})
        return cfg
    cfg = cs.ms_gold_deck(4)
    if case == "replicated":
        cfg["Solver"]["sharded scheme"] = "replicated"
    return cfg


def run_case(case, comm):
    """{"norms": [[time, kind, var, value], ...], "u": [...], "step":
    [...]} of a case over `comm`: the deck's run, and for "dof" one
    DofShardedStep Newton-CG step (30 iterations) at a seeded state."""
    import copy

    import numpy as np

    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.parallel.dof_sharding import DofShardedStep
    from mrhyde_tpu_torch.problem import Problem
    cfg = copy.deepcopy(case_cfg(case))
    cfg["Solver"]["shards"] = comm.n_shards
    p = Problem(cfg, device="cpu", comm=comm)
    res = p.run()
    out = {"norms": [[float(t), k[0], k[1], float(v)]
                     for t, errs in res.error_history
                     for k, v in sorted(errs.items())],
           "u": res.u.tolist(), "counts": res.counts}
    if case == "dof":
        st = DofShardedStep(p.assembler, comm, cg_iters=30)
        u = torch.as_tensor(np.random.RandomState(3).randn(p.n_dof))
        tc = TimeCoeffs.steady(p.n_dof)
        z = st.gather_global(torch.zeros(p.n_dof, dtype=torch.float64))
        u1, rn = st.newton_cg_step_fn()(st.gather_global(u), z, z, tc)
        out["step"] = st.scatter_global(u1).tolist()
        out["rnorm"] = float(rn)
        r = st.residual_fn()(st.gather_global(u), z, z, tc)
        out["residual"] = st.scatter_global(r).tolist()
    return out


def main(argv):
    rank, world, init_file, out_path, case = argv
    torch.set_num_threads(1)
    import torch.distributed as dist
    from mrhyde_tpu_torch.parallel.comm import ProcessGroupComm
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=int(rank), world_size=int(world))
    try:
        out = run_case(case, ProcessGroupComm())
    finally:
        dist.destroy_process_group()
    if int(rank) == 0:
        with open(out_path, "w") as f:
            json.dump(out, f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
