"""Plain reference of `ns_channel_p1`: steady Navier-Stokes on Q1 quads.

Equal-order Q1 velocity (ux, uy) and pressure pr, the density 1, the
viscosity nu (the deck's `viscosity`, 1 where it names none) and the body
force (f, 0) (its `source ux`), no-slip on the top and bottom,
do-nothing at the ends. Per 2 x 2 Gauss point, as MrHyDE's navierstokes
module writes it with PSPG:

  momentum d: (nu grad u_d - p e_d, grad v) + (u . grad u_d - f_d, v)
  continuity: (div u, q) + (tau R, grad q)
  R_d = u . grad u_d + dp/dx_d - f_d,
  tau = 1 / sqrt((4 nu / h^2)^2 + (2 |u| / h)^2),

with h the element's area^(1/2) and |u| read as |u|^2 where |u|^2 <=
1e-12. Dirichlet rows read u - 0.

`judge` reads each checked state only to judge it: its residual over
that of the zero state, what the deck's Newton solve drives under its
`nonlinear TOL`.
"""

from __future__ import annotations

import torch

from portbench.reference.q1 import Grid


class Channel:
    """The deck's mesh, its dof layout [ux | uy | pr] and its weak form."""

    def __init__(self, deck, device, dtype=torch.float64):
        m, phys, fns = deck["Mesh"], deck["Physics"], deck["Functions"]
        if phys.get("useSUPG", False) or not phys.get("usePSPG", False):
            raise ValueError("the reference holds the PSPG form alone")
        self.grid = g = Grid(m["NX"], m["NY"], m["xmin"], m["xmax"],
                             m["ymin"], m["ymax"], device, dtype)
        self.nu = float(fns.get("viscosity", 1.0))
        self.f = float(fns.get("source ux", 0.0))
        nn = g.n_nodes
        walls = g.side["top"] | g.side["bottom"]
        self.fixed = torch.cat([walls, walls, torch.zeros_like(walls)])
        # (E, 12) global dofs of each element's [ux(4), uy(4), pr(4)]
        self.dofs = torch.cat([g.conn + v * nn for v in range(3)], dim=1)

    def residual(self, u):
        """The global residual of state u (3 n_nodes,)."""
        g, nu = self.grid, self.nu
        ue = u[self.dofs].reshape(-1, 3, 4)
        val = torch.einsum("eva,qa->evq", ue, g.phi)        # (E, 3, Q)
        grd = torch.einsum("eva,qad->evqd", ue, g.grad)     # (E, 3, Q, 2)
        ux, uy = val[:, 0], val[:, 1]
        u2 = ux * ux + uy * uy
        big = u2 > 1e-12
        nvel = torch.where(big, torch.sqrt(torch.where(big, u2, 1.0)), u2)
        tau = 1.0 / torch.sqrt((4.0 * nu / (g.h * g.h)) ** 2
                               + (2.0 * nvel / g.h) ** 2)
        src = (self.f, 0.0)
        rows = []
        strong = []
        for i in range(2):
            conv = ux * grd[:, i, :, 0] + uy * grd[:, i, :, 1]
            S = conv - src[i]
            strong.append(S + grd[:, 2, :, i])
            F = [nu * grd[:, i, :, 0], nu * grd[:, i, :, 1]]
            F[i] = F[i] - val[:, 2]
            rows.append((S, F))
        div = grd[:, 0, :, 0] + grd[:, 1, :, 1]
        rows.append((div, [tau * strong[0], tau * strong[1]]))
        out = []
        for S, F in rows:
            out.append((S * g.wts) @ g.phi
                       + (F[0] * g.wts) @ g.grad[:, :, 0]
                       + (F[1] * g.wts) @ g.grad[:, :, 1])
        re = torch.cat(out, dim=1)                           # (E, 12)
        r = torch.zeros_like(u).index_add_(0, self.dofs.reshape(-1),
                                           re.reshape(-1))
        return torch.where(self.fixed, u, r)


def judge(deck, checked, device):
    """{"rel_residual": the largest ||R(u)|| / ||R(0)|| over the checked
    (sample, state) pairs}, in float64 on `device`."""
    ch = Channel(deck, device)
    worst = 0.0
    for _, state in checked:
        u = state.to(device=device, dtype=torch.float64)
        r0 = torch.linalg.norm(ch.residual(torch.zeros_like(u)))
        worst = max(worst, float(torch.linalg.norm(ch.residual(u)) / r0))
    return {"rel_residual": worst}
