"""Algebraic multigrid for meshes StructuredMG does not take
(aggregation-based).

The port of `mrhyde_tpu/solvers/amg.py` (the analog of the reference's
MueLu AMG option): tri / tet meshes, high-order layouts. Plain
(piecewise-constant) aggregation with a Galerkin product that never
materializes a sparse matrix: the tentative prolongator is a one-hot
aggregate map, so the coarse operator keeps the fine one's element-block
form (the (E, nd, nd) blocks unchanged, the dof ids coarsened: lids ->
agg[lids]), and every level's apply is the fine one's gather + batched
einsum + index_add_. The coarsest level (<= coarse_dofs) is dense and
LU-factored once per Jacobian.

The aggregation graph is built once per assembler on the host (numpy,
set-up time: `_greedy_aggregate` is a Python loop over the dofs); the
numeric hierarchy (diagonals, coarse dense matrix) derives from each
Jacobian on its device.

Smoother: damped Jacobi (weight 2/3); fixed (Dirichlet) dofs are excluded
from aggregation and ride the fine level's identity. Boundary-group
blocks are left out of the hierarchy, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from mrhyde_tpu_torch.solvers.precond import dense_blocks, segment_sum

__all__ = ["AggregationAMG"]


def _greedy_aggregate(n, adj_ptr, adj_idx, allowed):
    """Root-based greedy aggregation (MIS of the graph, then attach).

    Returns agg (n,) int: aggregate id, or -1 for excluded dofs."""
    agg = np.full(n, -1, dtype=np.int64)
    n_agg = 0
    # pass 1: roots with fully unaggregated allowed neighborhoods
    for i in range(n):
        if not allowed[i] or agg[i] >= 0:
            continue
        nb = adj_idx[adj_ptr[i]:adj_ptr[i + 1]]
        nb = nb[allowed[nb]]
        if np.any(agg[nb] >= 0):
            continue
        agg[i] = n_agg
        agg[nb] = n_agg
        n_agg += 1
    # pass 2: attach leftovers to an adjacent aggregate (or make a
    # singleton when isolated)
    for i in range(n):
        if not allowed[i] or agg[i] >= 0:
            continue
        nb = adj_idx[adj_ptr[i]:adj_ptr[i + 1]]
        hit = agg[nb[allowed[nb]]]
        hit = hit[hit >= 0]
        if hit.size:
            agg[i] = hit[0]
        else:
            agg[i] = n_agg
            n_agg += 1
    return agg, n_agg


def _adjacency(lids, n):
    """CSR dof-dof adjacency from element dof lists (numpy)."""
    E, nd = lids.shape
    src = np.repeat(lids, nd, axis=1).ravel()
    dst = np.tile(lids, (1, nd)).ravel()
    keep = src != dst
    pairs = np.unique(np.stack([src[keep], dst[keep]], axis=1), axis=0)
    ptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(ptr, pairs[:, 0] + 1, 1)
    ptr = np.cumsum(ptr)
    return ptr, pairs[:, 1]


class AggregationAMG:
    """Aggregation-AMG hierarchy for one assembler (any mesh)."""

    def __init__(self, assembler, coarse_dofs=600, max_levels=12,
                 nu=2, omega=2.0 / 3.0):
        lids = assembler.lids.cpu().numpy()
        fixed = assembler.fixed.cpu().numpy()
        n = fixed.shape[0]
        self.nu = nu
        self.omega = omega

        # level maps: aggs[l] maps level-l dof -> level-(l+1) dof (fixed
        # dofs only exist at level 0 and map nowhere: the fine identity
        # handles them and the cycle masks them out)
        self.aggs = []
        self.sizes = [n]
        cur_lids = lids
        cur_n = n
        allowed = ~fixed
        while cur_n > coarse_dofs and len(self.aggs) < max_levels - 1:
            ptr, idx = _adjacency(cur_lids, cur_n)
            agg, n_agg = _greedy_aggregate(cur_n, ptr, idx, allowed)
            if n_agg >= cur_n or n_agg == 0:
                break                      # no coarsening progress
            self.aggs.append(agg)
            # coarse "element" dof lists: aggregate ids of the fine ones;
            # excluded (fixed) slots park on aggregate 0, masked by the
            # zeroed blocks
            cur_lids = np.where(agg[cur_lids] >= 0, agg[cur_lids], 0)
            allowed = np.ones(n_agg, dtype=bool)
            cur_n = n_agg
            self.sizes.append(n_agg)
        self.n_levels = len(self.sizes)
        if self.n_levels < 2:
            raise ValueError("mesh too small for AMG")
        # per-level element dof ids (E, nd) on the device; level 0 uses
        # J.vol_lids
        dev = assembler.device
        maps = []
        ll = lids
        for agg in self.aggs:
            ll = np.where(agg[ll] >= 0, agg[ll], 0)
            maps.append(torch.as_tensor(ll, device=dev))
        self.level_lids = maps
        self.agg_dev = [torch.as_tensor(np.maximum(a, 0), device=dev)
                        for a in self.aggs]
        self.agg_valid = [torch.as_tensor(a >= 0, device=dev)
                          for a in self.aggs]

    # -- numeric hierarchy (per BlockJacobian) -------------------------

    def _masked_vol(self, J):
        """Element blocks with fixed rows/cols zeroed (the V-cycle
        corrects only free dofs; fine fixed rows ride the identity)."""
        fe = J.fixed[J.vol_lids]                       # (E, nd)
        mask = (~fe[:, :, None]) & (~fe[:, None, :])
        return torch.where(mask, J.aos(), 0.0)

    def preconditioner(self, J):
        """v -> V-cycle(v) against this J."""
        vol0 = self._masked_vol(J)
        levels = [(J.vol_lids, self.sizes[0])] + [
            (self.level_lids[lvl - 1], self.sizes[lvl])
            for lvl in range(1, self.n_levels)]

        # per-level assembled diagonals (+1 guard on empty/fixed rows)
        d0 = torch.diagonal(vol0, dim1=1, dim2=2)
        diags = []
        for ll, sz in levels:
            d = segment_sum(d0, ll, sz)
            diags.append(torch.where(d.abs() > 1e-300, d, 1.0))

        # coarsest dense matrix, factored once per Jacobian
        Ac = dense_blocks(vol0, *levels[-1])
        empty = torch.diagonal(Ac).abs() < 1e-300
        Ac = Ac + torch.diag(empty.to(Ac.dtype))
        lu, piv, _info = torch.linalg.lu_factor_ex(Ac)

        def apply_l(lvl, v):
            ll, sz = levels[lvl]
            return segment_sum(torch.einsum("eij,ej->ei", vol0, v[ll]),
                                ll, sz)

        def restrict(lvl, r):
            r = torch.where(self.agg_valid[lvl], r, 0.0)
            return segment_sum(r, self.agg_dev[lvl], self.sizes[lvl + 1])

        def prolong(lvl, e):
            return torch.where(self.agg_valid[lvl], e[self.agg_dev[lvl]],
                               0.0)

        nu, om = self.nu, self.omega

        def smooth(lvl, x, b):
            for _ in range(nu):
                x = x + om * (b - apply_l(lvl, x)) / diags[lvl]
            return x

        def vcycle(lvl, b):
            if lvl == self.n_levels - 1:
                return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
            x = smooth(lvl, torch.zeros_like(b), b)
            r = b - apply_l(lvl, x)
            e = vcycle(lvl + 1, restrict(lvl, r))
            x = x + prolong(lvl, e)
            return smooth(lvl, x, b)

        def M(v):
            x = vcycle(0, torch.where(J.fixed, 0.0, v))
            return torch.where(J.fixed, v, x)

        return M
