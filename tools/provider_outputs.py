"""The fused providers' outputs on the CPU, for a bitwise comparison of
two trees of this repository.

    python tools/provider_outputs.py TREE OUT.npz
    python tools/provider_outputs.py --compare A.npz B.npz

The first form imports mrhyde_tpu_torch from TREE (an unpacked `git
archive` of a commit, or the repository itself) and saves, for each deck
below, the residual and every Jacobian row of one `res_jac` call at a
seeded state (steady, or at a DIRK-2,2 stage-1 call with seeded betas),
f64, with the provider's class. The decks are those of the specialized
kernels: thermal (kappa 1 and 1 + e^2), cdr, thermal advection, NS on 2D
p1 (steady, viscosity reading x, PSPG+SUPG stage), hex thermal, p2
thermal, NS on hex and p2; and those of the 2D p1 module-set kernel:
NS + thermal, NS + cdr, thermal + cdr, cdr with velocity (c, y), NS
with viscosity 1 + ux^2. The second form prints the keys whose arrays
differ (none when the two trees compute the same bits).
"""

import os
import sys

import numpy as np


def save(tree, out):
    sys.path.insert(0, os.path.abspath(tree))
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tests"))
    import torch
    from torch_port_utils import (advection_cfg, cdr_cfg, channel_cfg,
                                  cdr_state_velocity_cfg, hex_cfg,
                                  ns_cdr_cfg, ns_elem_cfg, ns_thermal_cfg,
                                  p2_cfg, seeded, thermal_cdr_cfg,
                                  thermal_cfg)
    from mrhyde_tpu_torch.assembly.assembler import TimeCoeffs
    from mrhyde_tpu_torch.interop import time_coeffs_from_numpy
    from mrhyde_tpu_torch.problem import Problem
    torch.set_num_threads(1)
    transient = {"solver": "transient"}
    decks = {
        "thermal": (thermal_cfg(6), False),
        "thermal_nl": (thermal_cfg(6, kappa="1.0 + e*e"), False),
        "cdr_nl": (cdr_cfg(6, reaction="0.5*c*c"), False),
        "advection_rot": (advection_cfg(6, vel="rot"), False),
        "ns": (channel_cfg(6, 3), False),
        "ns_visc_x": (channel_cfg(6, 3, visc="0.1 + 0.01*x"), False),
        "ns_supg_stage": (channel_cfg(6, 3, supg=True, solver=transient),
                          True),
        "hex_nl": (hex_cfg(3, 3, 2, kappa="1.0 + e*e"), False),
        "p2_nl": (p2_cfg(3, kappa="1.0 + e*e"), False),
        "ns_hex_stage": (ns_elem_cfg("hex", (3, 2, 2), supg=True,
                                     solver=transient), True),
        "ns_p2": (ns_elem_cfg("p2", (3, 2)), False),
        "set_ns_thermal_stage": (ns_thermal_cfg(True, True, True), True),
        "set_ns_cdr_stage": (ns_cdr_cfg(), True),
        "set_thermal_cdr": (thermal_cdr_cfg("1.0 + e*c"), False),
        "set_cdr_velocity_c_stage": (cdr_state_velocity_cfg(), True),
        "set_ns_visc_ux2": (channel_cfg(4, 4, visc="1.0 + ux*ux"), False),
    }
    res = {}
    for name, (cfg, stage) in decks.items():
        p = Problem(cfg, device="cpu", dtype=torch.float64)
        f = p.assembler.fused_provider()
        n = p.n_dof
        tc = (time_coeffs_from_numpy(0.5, seeded(n, seed=11), 200.0,
                                     seeded(n, seed=12), 0.3, 0.01, p)
              if stage else TimeCoeffs.steady(n))
        r, rows = f.res_jac(torch.as_tensor(seeded(n, seed=9)), tc)
        res[f"{name}/residual"] = r.numpy()
        for k, x in enumerate(rows):
            if x is not None:
                res[f"{name}/row{k}"] = np.asarray(x)
        res[f"{name}/provider"] = np.array(type(f).__name__)
    np.savez(out, **res)
    print(f"{len(res)} arrays of {len(decks)} decks in {out}")


def compare(a, b):
    a, b = np.load(a), np.load(b)
    keys = sorted(set(a.files) | set(b.files))
    differ = [k for k in keys if k not in a.files or k not in b.files
              or not np.array_equal(a[k], b[k])]
    print(f"{len(keys)} arrays, {len(differ)} differ: {differ}")
    return 1 if differ else 0


if __name__ == "__main__":
    if sys.argv[1] == "--compare":
        sys.exit(compare(sys.argv[2], sys.argv[3]))
    save(sys.argv[1], sys.argv[2])
