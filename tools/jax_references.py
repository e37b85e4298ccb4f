"""Reference L2 errors of chip_smoke.py's cdr / thermal-advection decks,
its hex kappa = 1 deck and its B1 Navier-Stokes decks from the JAX
package, in f64 on the CPU.

    python tools/jax_references.py DECK [N[:STEPS] ...]

DECK is a key of chip_smoke.py's CDR_DECKS or NS_ELEM_DECKS, or
`hex_default` (its HEX_DEFAULT); each N builds the deck at that mesh
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
    decks = {k: (build, n, None, None)
             for k, (build, n, _rtol, _refs) in
             chip_smoke.NS_ELEM_DECKS.items()}
    decks.update(chip_smoke.CDR_DECKS, hex_default=chip_smoke.HEX_DEFAULT)
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


if __name__ == "__main__":
    main(sys.argv[1:])
