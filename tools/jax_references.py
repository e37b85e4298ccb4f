"""Reference L2 errors of chip_smoke.py's cdr / thermal-advection decks,
its hex decks, its B1 Navier-Stokes decks and its module-set decks from
the JAX package, in f64 on the CPU.

    python tools/jax_references.py DECK [N[:STEPS] ...]

DECK is a key of chip_smoke.py's CDR_DECKS, HEX_DECKS, NS_ELEM_DECKS,
SET_DECKS or SET_ELEM_DECKS, or `boussinesq_gold_nx8` (max |ux| of its
Boussinesq deck at beta = 1 and 0); each N builds the deck at that mesh
size (default: the size the card runs), and STEPS, for a transient deck,
sets its number of steps (to refine h and dt together). Prints one JSON
line per run: the L2 error of the deck's variable at its held time (an
NS deck: of every variable at every recorded time), the DOF count, and
the set-up and solve seconds. Run it from the repo root; it imports
chip_smoke.py for the deck functions, so both packages see the same
config.
"""

import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv):
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    from mrhyde_tpu.problem import Problem

    name, sizes = argv[0], argv[1:]
    if name == "boussinesq_gold_nx8":
        return boussinesq(chip_smoke, Problem)
    decks = {k: (build, n, None, None)
             for k, (build, n, _rtol, _refs) in
             {**chip_smoke.NS_ELEM_DECKS, **chip_smoke.SET_DECKS,
              **chip_smoke.SET_ELEM_DECKS}.items()}
    decks.update(chip_smoke.CDR_DECKS, **chip_smoke.HEX_DECKS)
    build, n_card, t_held, var = decks[name][:4]
    for size in sizes or [str(n_card)]:
        n, _, steps = size.partition(":")
        cfg = build(int(n))
        if steps:
            cfg["Solver"]["number of steps"] = int(steps)
        t0 = time.perf_counter()
        problem = Problem(cfg)
        t1 = time.perf_counter()
        result = problem.run()
        t2 = time.perf_counter()
        hist = {round(float(t), 10): errs
                for t, errs in result.error_history}
        if var is None:
            names = cfg["Postprocess"]["True solutions"]
            l2 = {t: {v: float(errs[("L2", v)]) for v in names}
                  for t, errs in hist.items()}
        else:
            l2 = float(hist[round(t_held, 10)][("L2", var)])
        print(json.dumps({"deck": name, "n": int(n), "steps":
                          cfg["Solver"].get("number of steps"),
                          "time": t_held,
                          "var": var, "L2": l2, "n_dof": problem.n_dof,
                          "setup_s": t1 - t0, "solve_s": t2 - t1}),
              flush=True)


def boussinesq(chip_smoke, Problem):
    """chip_smoke.py's boussinesq_gold_nx8: max |ux| at beta = 1 and 0."""
    import numpy as np
    out = {"deck": "boussinesq_gold_nx8"}
    for beta in (1.0, 0.0):
        t0 = time.perf_counter()
        problem = Problem(chip_smoke.boussinesq_deck(8, beta))
        u = np.asarray(problem.run().u)
        gd = np.asarray(problem.disc.dofmap.all_dofs("ux"))
        out[f"max_ux_beta{beta:g}"] = float(np.abs(u[gd]).max())
        out[f"seconds_beta{beta:g}"] = time.perf_counter() - t0
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
