"""Plain reference of `thermal2d_uq`: the steady heat equation on Q1 quads.

    -div(a grad u) = b  on the box,  u = 0 on its boundary,

with a and b the sample's stochastic parameters (the deck's `thermal
diffusion: a` and `thermal source: b`). The Galerkin residual is summed
over the 2 x 2 Gauss points of each element; a boundary node's row is
u - 0.

`judge` reads each checked state only to judge it: the residual of the
state in the reference's own weak form, over that of the initial state
(zero), which the deck's Newton solve drives under its `nonlinear TOL`.
"""

from __future__ import annotations

import torch

from portbench.reference.q1 import Grid


def residual(grid, u, a, b):
    """The residual node vector of state u (n_nodes,)."""
    ue = u[grid.conn]
    gq = grid.grads(ue)
    re = a * torch.einsum("q,eqd,qad->ea", grid.wts, gq, grid.grad) \
        - b * (grid.wts @ grid.phi)[None, :]
    r = grid.scatter(re.expand(grid.n_elems, 4))
    return torch.where(grid.boundary, u, r)


def judge(deck, checked, device):
    """{"rel_residual": the largest ||R(u)|| / ||R(0)|| of the checked
    (sample, state) pairs}, in float64 on `device`."""
    m = deck["Mesh"]
    grid = Grid(m["NX"], m["NY"], 0.0, 1.0, 0.0, 1.0, device)
    worst = 0.0
    for sample, state in checked:
        a, b = float(sample["a"]), float(sample["b"])
        u = state.to(device=device, dtype=torch.float64)
        r0 = torch.linalg.norm(residual(grid, torch.zeros_like(u), a, b))
        r = torch.linalg.norm(residual(grid, u, a, b))
        worst = max(worst, float(r / r0))
    return {"rel_residual": worst}
