"""End-to-end solves of module sets on hex and p2 quads through the port's
module-set provider (mrhyde_tpu_torch/ops/fused_set.py, `set_elem_full`'s
plain version on the CPU), against the JAX package's Problem.run():

- the hex channel (8x2x2) started from rest with cdr in the set, PSPG+
  SUPG, DIRK-2,2, two steps of 0.01: the error history of every
  variable at every recorded time (rtol 1e-9);
- mixed convection (NS + thermal with the Boussinesq term, thermal
  advected by the flow) on 8x2 p2 quads, PSPG, direct: L2 errors (rtol
  1e-9) and the solution (1e-10);
- a hex mixed-convection deck through both CLIs: the same L2 lines."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import yaml

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from torch_port_utils import (both_problems, ns_cdr_elem_cfg,  # noqa: E402
                              ns_thermal_elem_cfg)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIRECT = {"use direct solver": True, "nonlinear TOL": 1e-10}


def test_hex_ns_cdr_startup_history_matches_jax():
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    cfg = ns_cdr_elem_cfg("hex", (8, 2, 2), solver={
        "solver": "transient", "transient Butcher tableau": "DIRK-2,2",
        "final time": 0.02, "number of steps": 2, "nonlinear TOL": 1e-10})
    pj, pt = both_problems(cfg)
    fused = pt.assembler.fused_provider()
    assert isinstance(fused, FusedSetAssembly) and fused.nd == 40
    ht = pt.run().error_history
    hj = pj.run().error_history
    assert fused.stats["steady"] is False and not fused.stats["split"]
    assert [t for t, _ in ht] == pytest.approx([t for t, _ in hj],
                                               abs=1e-14)
    assert len(ht) == 3
    for (_, et), (_, ej) in zip(ht, hj):
        for v in ("ux", "uy", "uz", "pr", "c"):
            assert et[("L2", v)] == pytest.approx(ej[("L2", v)], rel=1e-9)


def test_p2_mixed_convection_direct_solve_matches_jax():
    from mrhyde_tpu_torch.interop import state_to_numpy
    from mrhyde_tpu_torch.ops.fused_set import FusedSetAssembly
    pj, pt = both_problems(ns_thermal_elem_cfg("p2", (8, 2), solver=DIRECT))
    fused = pt.assembler.fused_provider()
    assert isinstance(fused, FusedSetAssembly) and fused.nd == 36
    rt = pt.run()
    rj = pj.run()
    assert rt.newton.converged
    for v in ("ux", "uy", "pr", "e"):
        assert rt.errors[("L2", v)] == pytest.approx(rj.errors[("L2", v)],
                                                     rel=1e-9)
    assert np.max(np.abs(state_to_numpy(rt.u) - np.asarray(rj.u))) < 1e-10


def test_cli_hex_set_deck_prints_the_jax_l2_lines(tmp_path):
    deck = tmp_path / "input.yaml"
    deck.write_text(yaml.safe_dump(ns_thermal_elem_cfg("hex", (6, 2, 2),
                                                       solver=DIRECT)))
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    env["OMP_NUM_THREADS"] = "1"

    def l2_lines(cmd):
        out = subprocess.run(cmd, capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=600)
        assert out.returncode == 0, out.stderr
        return sorted(ln for ln in out.stdout.splitlines()
                      if "L2 norm of the error for" in ln)

    port = l2_lines([sys.executable, "-m", "mrhyde_tpu_torch.driver",
                     str(deck), "--device", "cpu"])
    ref = l2_lines([sys.executable, "-m", "mrhyde_tpu.driver", str(deck),
                    "--cpu", "--fp64"])
    assert len(port) == 5 and port == ref
