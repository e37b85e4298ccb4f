"""Several subgrid models in mrhyde_tpu_torch (`MultiscaleModels`)
against the JAX package on the CPU in f64: static models chosen by usage
votes per (virtual rank x workset group) under 'assembly partitioning:
subgrid-preserving' (the reference quirk the JAX package reproduces),
dynamic models re-voted every step with the fine state L2-projected onto
the new owner, and ML selection (a softmax regression trained from the
votes of the first steps, then predicting the owners). Decks:
chip_smoke.py's multimodel_deck and dynamic_multimodel_deck at 8x8."""

import copy

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import chip_smoke as cs  # noqa: E402
from torch_port_utils import both_problems, solve_both  # noqa: E402

torch.set_num_threads(1)

RTOL = 1e-10


def test_static_multimodel_matches_jax():
    """Both models' Subgrid-L2 and the macro L2-face at 1e-10; the vote
    groups and the owners equal JAX's."""
    pj, pt = both_problems(cs.multimodel_deck(8, workset=6))
    mj, mt = pj.multiscale, pt.multiscale
    assert [list(g) for g in mt._vote_groups()] \
        == [list(g) for g in mj._vote_groups()]
    assert [list(m.elems) for m in mt.models] \
        == [list(m.elems) for m in mj.models]
    assert 0 < len(mt.models[1].elems) < 16   # less than the usage quarter
    _rj, rt, _pt = solve_both(cs.multimodel_deck(8, workset=6), rtol=RTOL)
    assert ("Subgrid-L2:1", "e") in rt.errors


def test_dynamic_multimodel_matches_jax():
    """Three models whose usage moves with t, re-voted at each step: the
    error history of all three at 1e-10, the owners at the last step
    JAX's."""
    rj, rt, pt = solve_both(cs.dynamic_multimodel_deck(8, steps=3), rtol=RTOL)
    masks = [m.mask for m in pt.multiscale.models]
    assert sum(masks).tolist() == [1.0] * 64
    # every model owned elements at some recorded time
    for k in range(3):
        kind = "Subgrid-L2" if k == 0 else f"Subgrid-L2:{k}"
        assert any(e[(kind, "e")] > 0 for _t, e in rt.error_history)


def test_ml_selection_matches_jax():
    """'subgrid model selection: ML' after 2 training steps: the owners
    the classifier predicts at every vote time equal JAX's, and the run's
    history matches at 1e-10. (The weights themselves agree to ~1e-3
    only: Adam's normalized steps amplify rounding where the gradient
    vanishes, in the softmax-invariant direction and for classes no label
    names; ROADMAP §C.)"""
    cfg = cs.dynamic_multimodel_deck(8, steps=3, ml=True)
    pj, pt = both_problems(copy.deepcopy(cfg))
    rj, rt = pj.run(), pt.run()
    mj, mt = pj.multiscale, pt.multiscale
    assert mt._ml_steps == mj._ml_steps == 2 and mt._ml_W is not None
    for t in (0.0, 0.1, 0.2, 0.3):
        assert np.array_equal(mt._ml_predict(t), mj._ml_predict(t))
    for (tj, ej), (tt, et) in zip(rj.error_history, rt.error_history):
        assert tj == tt
        for k, v in ej.items():
            assert abs(et[k] - v) <= max(RTOL * abs(v), 1e-13), (tj, k)
