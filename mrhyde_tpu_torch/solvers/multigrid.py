"""Geometric multigrid preconditioner for structured p1 meshes.

The port of `mrhyde_tpu/solvers/multigrid.py` (the analog of the
reference's MueLu AMG preconditioner). On structured quad / hex meshes
with p1 HGRAD variables the grid hierarchy is geometric (halve each
axis), the transfer operators are (bi/tri)linear interpolation as strided
slices of the per-variable node grids, and the coarse operators come from
coarsening the per-element Jacobian blocks,

    A_C[ce] = sum_{sub} P_sub A_f[fine(ce, sub)] P_sub

one batched (Ec, 2^dim, nd, nd) contraction per level, with the JAX
package's index order (its P_sub holds fine corners in rows and coarse
corners in columns, and the contraction reads it untransposed on the
left: ROADMAP.md, the JAX package's faults ported as they are). The
coarsest level is factored dense (LU) once per Jacobian; smoothing is
damped node-block Jacobi.

The index machinery (level dims, fine->coarse element maps, fixed-dof
masks) is numpy built once per assembler and held as tensors on its
device; `preconditioner(J)` derives the operators of one Jacobian on the
device, and the V-cycle reads no host value.
"""

from __future__ import annotations

from itertools import product

import numpy as np
import torch

from mrhyde_tpu_torch.solvers.precond import dense_blocks, segment_sum
from mrhyde_tpu_torch.utils.profiling import count, timed

__all__ = ["StructuredMG", "build_mg_preconditioner"]


def _hat(c, xi):
    return 1.0 - xi if c == 0 else xi


class StructuredMG:
    """Grid hierarchy + transfer operators for one assembler."""

    def __init__(self, assembler, coarse_dofs=600, max_levels=10):
        s = assembler._structured
        if s is None or any(k != "p1" for (k, _n, _st) in s["plan"]):
            raise ValueError("multigrid needs a structured all-p1 mesh")
        self.asm = assembler
        dev, dt = assembler.device, assembler.dtype
        self.dim = len(s["dims"])
        self.corners = s["corners"]
        self.nc = len(self.corners)
        self.vars = [n for (_k, n, _st) in s["plan"]]
        self.n_var = len(self.vars)
        nd = self.n_var * self.nc

        # level 0 = fine
        dims = [tuple(int(d) for d in s["dims"])]
        while (len(dims) < max_levels
               and all(d % 2 == 0 and d >= 4 for d in dims[-1])):
            nxt = tuple(d // 2 for d in dims[-1])
            ndof_next = self.n_var * int(np.prod([d + 1 for d in nxt]))
            dims.append(nxt)
            if ndof_next <= coarse_dofs:
                break
        self.dims = dims
        self.n_levels = len(dims)

        # per-level dof layout: var-major blocks of node grids
        self.grids = [tuple(d + 1 for d in dd) for dd in dims]
        self.ndof = [self.n_var * int(np.prod(g)) for g in self.grids]
        self.starts = [[v * int(np.prod(g)) for v in range(self.n_var)]
                       for g in self.grids]

        # per-level element lids (E_l, nd), same corner pattern
        lids_np = []
        for li, dd in enumerate(dims):
            g = self.grids[li]
            idx = np.arange(int(np.prod(g))).reshape(g)
            el = []
            for off in self.corners:
                sl = tuple(slice(o, o + d) for o, d in zip(off, dd))
                el.append(idx[sl].ravel())
            el = np.stack(el, axis=1)                   # (E_l, nc)
            lids_np.append(np.concatenate(
                [self.starts[li][v] + el for v in range(self.n_var)],
                axis=1))
        # the hierarchy reads the assembler's dofs as var-major node
        # grids with its element blocks in this corner order: hold the
        # assembler to it
        if [st for (_k, _n, st) in s["plan"]] != self.starts[0] \
                or assembler.n_dof != self.ndof[0] \
                or not np.array_equal(lids_np[0],
                                      assembler.lids.cpu().numpy()):
            raise RuntimeError(
                "StructuredMG: the assembler's dofs are not var-major "
                "node grids in the structured plan's corner order")
        self.lids = [torch.as_tensor(x, device=dev) for x in lids_np]

        # fixed masks per level (injection: coarse node (I,)=fine (2I,))
        f0 = assembler.fixed.cpu().numpy()
        fixed = [f0]
        for li in range(1, self.n_levels):
            gc, gf = self.grids[li], self.grids[li - 1]
            fc = np.zeros(self.ndof[li], dtype=bool)
            ff = fixed[li - 1]
            for v in range(self.n_var):
                fv = ff[self.starts[li - 1][v]:
                        self.starts[li - 1][v] + int(np.prod(gf))]
                fv = fv.reshape(gf)
                sl = tuple(slice(None, None, 2) for _ in gf)
                fc[self.starts[li][v]:
                   self.starts[li][v] + int(np.prod(gc))] = fv[sl].ravel()
            fixed.append(fc)
        self.fixed = fixed
        self.fixed_j = [torch.as_tensor(f, device=dev) for f in fixed]

        # fine->coarse element grouping (Ec, 2^dim)
        subs = list(product((0, 1), repeat=self.dim))
        self.group = []
        for li in range(1, self.n_levels):
            ddc, ddf = dims[li], dims[li - 1]
            Ic = np.indices(ddc).reshape(self.dim, -1).T   # (Ec, dim)
            cols = []
            for sub in subs:
                fidx = 2 * Ic + np.asarray(sub)            # (Ec, dim)
                flat = np.zeros(len(fidx), dtype=np.int64)
                for a in range(self.dim):
                    flat = flat * ddf[a] + fidx[:, a]
                cols.append(flat)
            self.group.append(torch.as_tensor(np.stack(cols, axis=1),
                                              device=dev))

        # static local interpolation P_sub (nc, nc): fine corner value
        # of sub-element `sub` from coarse corner values
        P = np.zeros((len(subs), self.nc, self.nc))
        for si, sub in enumerate(subs):
            for fi, foff in enumerate(self.corners):
                xi = [(sub[a] + foff[a]) / 2.0 for a in range(self.dim)]
                for ci, coff in enumerate(self.corners):
                    w = 1.0
                    for a in range(self.dim):
                        w *= _hat(coff[a], xi[a])
                    P[si, fi, ci] = w
        # expand to block (var-major) layout: nd x nd
        Pb = np.zeros((len(subs), nd, nd))
        for v in range(self.n_var):
            Pb[:, v * self.nc:(v + 1) * self.nc,
               v * self.nc:(v + 1) * self.nc] = P
        self.P_sub = torch.as_tensor(Pb, dtype=dt, device=dev)
        self.nd = nd

    # ---- vector transfers (per-var node grids) -----------------------

    def _var_grid(self, li, vec, v):
        g = self.grids[li]
        st = self.starts[li][v]
        return vec[st:st + int(np.prod(g))].reshape(g)

    def _parity_slices(self, gc, parity):
        """The coarse-grid slices whose sum, times 0.5^|parity|, is the
        fine nodes of that parity (offset 0 or 1 along each odd axis)."""
        for delta in product(*[(0, 1) if pa else (0,) for pa in parity]):
            yield tuple(slice(d, d + gc[a] - pa)
                        for a, (d, pa) in enumerate(zip(delta, parity)))

    def prolong(self, li, vc):
        """Level li+1 (coarse) vector -> level li (fine)."""
        gc, gf = self.grids[li + 1], self.grids[li]
        out = []
        for v in range(self.n_var):
            c = self._var_grid(li + 1, vc, v)
            f = vc.new_zeros(gf)
            for parity in product((0, 1), repeat=self.dim):
                acc = 0.0
                for sl in self._parity_slices(gc, parity):
                    acc = acc + c[sl]
                f[tuple(slice(pa, None, 2) for pa in parity)] = \
                    0.5 ** sum(parity) * acc
            out.append(f.reshape(-1))
        return torch.cat(out)

    def restrict(self, li, vf):
        """Level li (fine) vector -> level li+1 (coarse), = prolong^T."""
        gc = self.grids[li + 1]
        out = []
        for v in range(self.n_var):
            f = self._var_grid(li, vf, v)
            c = vf.new_zeros(gc)
            for parity in product((0, 1), repeat=self.dim):
                src = 0.5 ** sum(parity) * f[tuple(slice(pa, None, 2)
                                                   for pa in parity)]
                for sl in self._parity_slices(gc, parity):
                    c[sl] += src
            out.append(c.reshape(-1))
        return torch.cat(out)

    # ---- operator hierarchy ------------------------------------------

    def _fold_boundary(self, J):
        """The volume blocks with the active boundary groups' Jacobian
        blocks added onto their owning elements (a group's blocks share
        that element's dof set): J.bnd holds one entry per active group,
        in the assembler's order of its groups."""
        vol = J.aos()
        if not J.bnd:
            return vol
        active = self.asm._active_bnd_groups()
        elems = [torch.as_tensor(bg.elems, device=vol.device)
                 for g, bg in zip(self.asm._bnd,
                                  self.asm.disc.boundary_groups)
                 if any(g is a for a in active)]
        for blk, el in zip(J.bnd, elems):
            vol = vol.index_add(0, el, blk)
        return vol

    def operators(self, J):
        """Element-block operators per level by coarsening."""
        blocks = [self._fold_boundary(J)]
        for li in range(1, self.n_levels):
            sub_blocks = blocks[-1][self.group[li - 1]]  # (Ec, S, nd, nd)
            blocks.append(torch.einsum("sik,eskl,slj->eij", self.P_sub,
                                       sub_blocks, self.P_sub))
        return blocks

    def _apply(self, li, blocks, v):
        fixed = self.fixed_j[li]
        lids = self.lids[li]
        vm = torch.where(fixed, 0.0, v)
        av = segment_sum(torch.einsum("eij,ej->ei", blocks, vm[lids]),
                          lids, self.ndof[li])
        return torch.where(fixed, v, av)

    def _node_block_inv(self, li, blocks):
        """Inverted per-node (n_var, n_var) diagonal blocks: the smoother
        couples the variables (point Jacobi fails where a variable's own
        diagonal degenerates but the cross coupling does not)."""
        nv, nc = self.n_var, self.nc
        nn = self.ndof[li] // nv
        node_ids = self.lids[li][:, :nc] - self.starts[li][0]  # (E, nc)
        D = blocks.new_zeros((nn, nv, nv))
        for v in range(nv):
            for w in range(nv):
                vals = torch.diagonal(blocks[:, v * nc:(v + 1) * nc,
                                             w * nc:(w + 1) * nc],
                                      dim1=1, dim2=2)         # (E, nc)
                D[:, v, w] += segment_sum(vals, node_ids, nn)
        # fixed dofs: decouple with a unit diagonal
        fx = self.fixed_j[li].reshape(nv, nn).T                # (nn, nv)
        keep = (~fx[:, :, None]) & (~fx[:, None, :])
        eye = torch.eye(nv, dtype=blocks.dtype, device=blocks.device)
        D = torch.where(keep, D, 0.0) + eye * fx[:, :, None]
        dd = torch.diagonal(D, dim1=1, dim2=2)
        D = D + eye * torch.where(dd == 0, 1.0, 0.0)[:, :, None]
        return torch.linalg.inv_ex(D)[0]

    def _block_smooth_apply(self, li, Dinv, r):
        nv = self.n_var
        rv = r.reshape(nv, self.ndof[li] // nv)               # var-major
        return torch.einsum("nvw,wn->vn", Dinv, rv).reshape(-1)

    def _coarse_dense(self, blocks):
        li = self.n_levels - 1
        A = dense_blocks(blocks, self.lids[li], self.ndof[li])
        fixed = self.fixed_j[li]
        A = torch.where(fixed[:, None] | fixed[None, :], 0.0, A)
        A = A + torch.diag(fixed.to(A.dtype))
        # guard empty rows (dofs untouched at this level)
        return A + torch.diag((torch.diagonal(A) == 0).to(A.dtype))

    def preconditioner(self, J, nu1=2, nu2=2, omega=0.8, cycles=1):
        """v -> MG-V(v), a closure over the current Jacobian's
        operators. Spans: mg::setup here, mg::vcycle per call of the
        closure, mg::level<i> around level i's smoothing, residual and
        transfers (0 the finest; the coarser levels nest inside),
        mg::coarse around the coarse LU solve; the counter
        mg::smoother_sweeps."""
        with timed("mg::setup"):
            blocks = self.operators(J)
            dinvs = [self._node_block_inv(li, blocks[li])
                     for li in range(self.n_levels)]
            lu, piv, _info = torch.linalg.lu_factor_ex(
                self._coarse_dense(blocks[-1]))
        levels = [f"mg::level{li}" for li in range(self.n_levels)]

        def smooth(li, x, b, nu):
            for _ in range(nu):
                r = b - self._apply(li, blocks[li], x)
                x = x + omega * self._block_smooth_apply(li, dinvs[li], r)
            count("mg::smoother_sweeps", nu)
            return x

        def vcycle(li, b):
            if li == self.n_levels - 1:
                with timed("mg::coarse"):
                    return torch.linalg.lu_solve(lu, piv, b[:, None])[:, 0]
            with timed(levels[li]):
                x = smooth(li, torch.zeros_like(b), b, nu1)
                r = b - self._apply(li, blocks[li], x)
                r = torch.where(self.fixed_j[li], 0.0, r)
                rc = self.restrict(li, r)
                rc = torch.where(self.fixed_j[li + 1], 0.0, rc)
                ec = vcycle(li + 1, rc)
                ec = torch.where(self.fixed_j[li + 1], 0.0, ec)
                x = x + self.prolong(li, ec)
                return smooth(li, x, b, nu2)

        def M(v):
            with timed("mg::vcycle"):
                x = vcycle(0, v)
                for _ in range(cycles - 1):
                    x = x + vcycle(0, v - self._apply(0, blocks[0], x))
                return x

        return M


def build_mg_preconditioner(assembler, J, **kw):
    """Convenience: StructuredMG cached on the assembler + V-cycle."""
    mg = assembler.__dict__.get("_mg_hierarchy")
    if mg is None:
        mg = StructuredMG(assembler)
        assembler.__dict__["_mg_hierarchy"] = mg
    return mg.preconditioner(J, **kw)
