"""Reference L2 errors of chip_smoke.py's cdr / thermal-advection decks,
its hex decks, its B1 Navier-Stokes decks, its module-set decks, its
solver decks, its mesh and solid decks, its physics decks and its vector
decks from the JAX package, in f64 on the CPU.

    python tools/jax_references.py [--shards S] [--seed S] \
        [--solver JSON] DECK [N[:STEPS] ...]

DECK is a key of chip_smoke.py's CDR_DECKS, HEX_DECKS, NS_ELEM_DECKS,
SET_DECKS, SET_ELEM_DECKS, BOUNDARY_DECKS, AFFINE_SET_DECKS,
QUADRATURE_DECKS, SOLVER_DECKS, MULTISET_DECKS, MESH_DECKS, SOLID_DECKS
(whose files,
an Exodus mesh and grain rotations, the deck functions write from
--seed, default 0, into a temporary directory, as chip_smoke.py does),
PHYSICS_DECKS, VECTOR_DECKS or MULTISCALE_DECKS, or `boussinesq_gold_nx8`
(max |ux| of its
Boussinesq deck at beta = 1 and 0); each N builds the deck at that mesh
size (default: the size the card runs), and STEPS, for a transient deck,
sets its number of steps (to refine h and dt together); --solver merges
the JSON object's keys into the deck's Solver sublist (e.g. '{"use
direct solver": false, "preconditioner variant": "schwarz"}', to see
which Krylov solve converges a deck: its L2 against the dense solve's);
--shards S runs the deck's Newton solves sharded (`Solver: shards: S`)
over S virtual CPU devices (S <= 8), as the JAX package's sharded tests
do; a SHARDED_DECKS key is the deck of chip_smoke.py's phase
sharded_decks, whose sharded references come from this option.
Prints one JSON line per run: the L2 error of the deck's variable at its
held time (an NS, mesh, solid, physics or vector deck: of every variable
at every recorded time, a multi-block mesh's per block as "var@b", an
L2-grad, L2-face, L2-div or L2-curl norm as "var#L2-grad", a subgrid
model's L2 as "var#Subgrid-L2" or "var#Subgrid-L2:k"), the DOF
count, and the set-up and solve seconds. Run it from the repo root; it imports
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
    shards = 0
    if argv[0] == "--shards":
        shards = int(argv[1])
        argv = argv[2:]
        # the virtual devices exist only if asked for before jax starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device"
                                   "_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import chip_smoke
    from mrhyde_tpu.problem import make_problem

    if argv[0] == "--seed":
        chip_smoke.SEED = int(argv[1])
        argv = argv[2:]
    solver = {}
    if argv[0] == "--solver":
        solver = json.loads(argv[1])
        argv = argv[2:]
    name, sizes = argv[0], argv[1:]
    if name == "boussinesq_gold_nx8":
        return boussinesq(chip_smoke, make_problem)
    decks = {k: (build, n, None, None)
             for k, (build, n, _rtol, _refs, *_mode) in
             {**chip_smoke.NS_ELEM_DECKS, **chip_smoke.SET_DECKS,
              **chip_smoke.SET_ELEM_DECKS, **chip_smoke.BOUNDARY_DECKS,
              **chip_smoke.AFFINE_SET_DECKS,
              **chip_smoke.QUADRATURE_DECKS,
              **chip_smoke.SOLVER_DECKS,
              **chip_smoke.MULTISET_DECKS}.items()}
    decks.update({k: (build, n, None, None) for k, (build, n, *_rest) in
                  {**chip_smoke.MESH_DECKS, **chip_smoke.SOLID_DECKS,
                   **chip_smoke.PHYSICS_DECKS, **chip_smoke.VECTOR_DECKS,
                   **chip_smoke.MULTISCALE_DECKS,
                   **chip_smoke.SHARDED_DECKS}.items()})
    decks.update(chip_smoke.CDR_DECKS, **chip_smoke.HEX_DECKS)
    build, n_card, t_held, var = decks[name][:4]
    for size in sizes or [str(n_card)]:
        n, _, steps = size.partition(":")
        cfg = build(int(n))
        if steps:
            cfg["Solver"]["number of steps"] = int(steps)
        cfg["Solver"].update(solver)
        if shards:
            cfg["Solver"]["shards"] = shards
        t0 = time.perf_counter()
        problem = make_problem(cfg)
        t1 = time.perf_counter()
        # a discretized parameter's field rides pvec at its deck value
        # (the JAX package's run() passes none, and a boundary condition
        # that reads the field cannot resolve it; the port's run() passes
        # every field at its current value)
        pm = getattr(problem, "param_manager", None)
        fields = {} if pm is None else {
            n: jax.numpy.asarray(pm.specs[n].value, dtype=float)
            for n in pm.discretized_names()}
        result = problem.forward(pvec=fields) if fields else problem.run()
        t2 = time.perf_counter()
        hist = {round(float(t), 10): errs
                for t, errs in result.error_history}
        if var is None:
            l2 = {t: chip_smoke.ms_labels(errs) for t, errs in hist.items()}
        else:
            l2 = float(hist[round(t_held, 10)][("L2", var)])
        print(json.dumps({"deck": name, "n": int(n), "steps":
                          cfg["Solver"].get("number of steps"),
                          "solver": solver, "shards": shards,
                          "time": t_held,
                          "var": var, "L2": l2,
                          "n_dof": getattr(problem, "n_dof", None) or sum(
                              p.n_dof for p in problem.sets),
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
