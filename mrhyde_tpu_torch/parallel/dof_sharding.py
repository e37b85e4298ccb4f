"""Distribution v2: DOF-sharded assembly with explicit halo exchange.

The port of the JAX package's `mrhyde_tpu/parallel/dof_sharding.py`,
the counterpart of the reference's owned/overlapped Tpetra maps and
their Import/Export (src/interfaces/linearAlgebraInterface.cpp:145-309;
solverManager.cpp:1556,1652). The DOF vector itself is partitioned, so
the problem size scales with the number of shards:

- elements are cut into contiguous chunks, one per shard;
- each DOF is OWNED by the first shard whose elements touch it;
- each shard keeps a ghost list for the dofs its elements reference but
  does not own. Contiguous partitions of meshes numbered in
  lexicographic order only reference neighbour shards, so the halo
  exchange is one ring shift each way (the Import, `_halo_gather`), and
  the reduction of the boundary sums after the scatter is the reverse
  pair of shifts (the Export, `_halo_reduce`).

Every per-shard step runs over a communicator (parallel/comm.py) on
tensors whose leading dimension is the shards held here: StackedComm
assembles all S shards in one torch.func.vmap(jacfwd) over the S x emax
padded elements, ProcessGroupComm one shard per rank. Scatters go
through per-shard incidence tables (a fixed-fan-in gather + sum, no
atomics), and the Krylov dot products are per-shard partial sums that
`psum` adds.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch.utils._pytree import tree_map

from mrhyde_tpu_torch.assembly.assembler import (_fold_W, _fold_WT,
                                                 _fold_jac_WT_W)

__all__ = ["DofPartition", "build_dof_partition", "DofShardedStep"]


@dataclass
class DofPartition:
    """Host-side owned/ghost layout (the Tpetra map analog)."""
    n_shards: int
    n_dof: int
    owner: np.ndarray            # (n_dof,) owning shard
    local_pos: np.ndarray        # (n_dof,) position within owner's slice
    owned: list                  # per shard: global dof ids (ascending)
    nmax: int                    # padded owned-slice length
    gp_max: int                  # padded ghost-from-prev length
    gn_max: int                  # padded ghost-from-next length
    cuts: np.ndarray             # (S+1,) element chunk boundaries
    emax: int                    # padded elements per shard
    gprev: list = field(default_factory=list)   # per shard: ghost dofs
    gnext: list = field(default_factory=list)   #   owned by s-1 / s+1
    # per-shard index tables, all (S, ...) numpy arrays
    arrays: dict = field(default_factory=dict)

    def ext_index(self, s: int, dofs: np.ndarray) -> np.ndarray:
        """Map global dof ids -> shard s's extended-vector positions
        ([owned | ghost_prev | ghost_next | zero])."""
        dofs = np.asarray(dofs)
        flat = dofs.ravel()
        own = self.owner[flat]
        out = np.full(flat.shape[0], -1, dtype=np.int64)
        here = own == s
        out[here] = self.local_pos[flat[here]]
        for side, base, ghosts in ((-1, self.nmax, self.gprev),
                                   (1, self.nmax + self.gp_max,
                                    self.gnext)):
            if not 0 <= s + side < self.n_shards:
                continue
            sel = own == s + side
            g = ghosts[s]
            pos = np.searchsorted(g, flat[sel])
            found = pos < g.size
            found[found] = g[pos[found]] == flat[sel][found]
            pos[~found] = -1 - base
            out[sel] = base + pos
        bad = out < 0
        if bad.any():
            d = int(flat[bad][0])
            raise ValueError(f"dof {d} (owner {self.owner[d]}) not "
                             f"reachable from shard {s}")
        return out.reshape(dofs.shape)

    @property
    def ext_len(self):
        # [owned | ghost_prev | ghost_next | zero slot]
        return self.nmax + self.gp_max + self.gn_max + 1

    def to_sharded(self, vec):
        """Global (n_dof,) -> (S, nmax) owned slices (numpy)."""
        vec = np.asarray(vec)
        out = np.zeros((self.n_shards, self.nmax), dtype=vec.dtype)
        for s, o in enumerate(self.owned):
            out[s, :len(o)] = vec[o]
        return out

    def from_sharded(self, arr):
        """(S, nmax) owned slices -> global (n_dof,) (numpy)."""
        arr = np.asarray(arr)
        out = np.zeros(self.n_dof, dtype=arr.dtype)
        for s, o in enumerate(self.owned):
            out[o] = arr[s, :len(o)]
        return out


def build_dof_partition(assembler, n_shards: int) -> DofPartition:
    """Partition elements contiguously and derive DOF ownership + halos.

    Raises if any element references a dof owned by a non-neighbor
    shard (meshes numbered in lexicographic order never do; for such
    meshes use the replicated scheme in parallel/sharding.py).
    """
    lids = np.asarray(assembler.disc.lids)             # (E, nd)
    E, nd = lids.shape
    n_dof = assembler.n_dof
    cuts = np.linspace(0, E, n_shards + 1).astype(np.int64)

    owner = np.full(n_dof, np.iinfo(np.int32).max, dtype=np.int64)
    for s in range(n_shards - 1, -1, -1):
        owner[np.unique(lids[cuts[s]:cuts[s + 1]])] = s
    if owner.max() >= n_shards:
        # dofs untouched by any element (shouldn't happen) -> shard 0
        owner[owner >= n_shards] = 0

    owned = [np.where(owner == s)[0] for s in range(n_shards)]
    nmax = max(len(o) for o in owned)
    local_pos = np.zeros(n_dof, dtype=np.int64)
    for o in owned:
        local_pos[o] = np.arange(len(o))

    gprev, gnext = [], []
    for s in range(n_shards):
        d = np.unique(lids[cuts[s]:cuts[s + 1]])
        g = d[owner[d] != s]
        far = g[np.abs(owner[g] - s) > 1]
        if far.size:
            raise ValueError(
                "DOF adjacency spans non-neighbor shards "
                f"(shard {s} references dofs owned by "
                f"{sorted(set(owner[far].tolist()))}); renumber the mesh "
                "or use the replicated scheme")
        gprev.append(g[owner[g] == s - 1])
        gnext.append(g[owner[g] == s + 1])
    gp_max = max((len(g) for g in gprev), default=0) or 1
    gn_max = max((len(g) for g in gnext), default=0) or 1

    part = DofPartition(n_shards=n_shards, n_dof=n_dof, owner=owner,
                        local_pos=local_pos, owned=owned, nmax=nmax,
                        gp_max=gp_max, gn_max=gn_max, cuts=cuts,
                        emax=int(np.diff(cuts).max()),
                        gprev=gprev, gnext=gnext)

    # ---- per-shard index tables -------------------------------------
    S, emax = n_shards, part.emax
    ext_zero = part.ext_len - 1
    lids_l = np.full((S, emax, nd), ext_zero, dtype=np.int64)
    signs_l = np.ones((S, emax, nd))
    e_valid = np.zeros((S, emax), dtype=bool)
    # what I send to my NEXT neighbor = their ghost_prev, in MY local
    # positions (padded entries -> trash slot nmax)
    send_next = np.full((S, gp_max), nmax, dtype=np.int64)
    send_prev = np.full((S, gn_max), nmax, dtype=np.int64)
    dm = assembler.disc.dofmap
    signs = np.asarray(dm.signs) if assembler.has_signs else None
    # 2x2 orientation mixing channel (tet HCURL order >= 2): mix_pair
    # is a per-element LOCAL slot index, so it chunks exactly like the
    # signs; pad rows mix with themselves at weight zero
    mixp_np = None if dm.mix_pair is None else np.asarray(dm.mix_pair)
    if mixp_np is not None:
        mixw_np = np.asarray(dm.mix_w)
        mixp_l = np.tile(np.arange(nd, dtype=np.int64), (S, emax, 1))
        mixw_l = np.zeros((S, emax, nd))
    for s in range(n_shards):
        el = lids[cuts[s]:cuts[s + 1]]                 # (Es, nd)
        ne = el.shape[0]
        lids_l[s, :ne] = part.ext_index(s, el)
        e_valid[s, :ne] = True
        if signs is not None:
            signs_l[s, :ne] = signs[cuts[s]:cuts[s + 1]]
        if mixp_np is not None:
            mixp_l[s, :ne] = mixp_np[cuts[s]:cuts[s + 1]]
            mixw_l[s, :ne] = mixw_np[cuts[s]:cuts[s + 1]]
        if s + 1 < n_shards:
            send_next[s, :len(gprev[s + 1])] = local_pos[gprev[s + 1]]
        if s - 1 >= 0:
            send_prev[s, :len(gnext[s - 1])] = local_pos[gnext[s - 1]]

    fixed = assembler.fixed.cpu().numpy()
    fixed_own = np.zeros((S, nmax), dtype=bool)
    valid_own = np.zeros((S, nmax), dtype=bool)
    for s, o in enumerate(owned):
        fixed_own[s, :len(o)] = fixed[o]
        valid_own[s, :len(o)] = True

    part.arrays = {
        "lids": lids_l, "signs": signs_l, "e_valid": e_valid,
        "send_next": send_next, "send_prev": send_prev,
        "fixed": fixed_own, "valid": valid_own,
    }
    if mixp_np is not None:
        part.arrays["mix"] = {
            "p": mixp_l, "w": mixw_l,
            "wT": np.take_along_axis(mixw_l, mixp_l, axis=2)}
    return part


def shard_incidence(lids, n_slots):
    """(S, n_slots, deg) incidence of per-shard index tables lids (S, n,
    k): for each shard and slot < n_slots, its positions in lids[s].ravel()
    in order, padded with n*k (a zero slot). Entries >= n_slots (the trash
    slot of padded rows) are left out: nothing reads their sum."""
    lids = np.asarray(lids)
    S = lids.shape[0]
    flat = lids.reshape(S, -1)
    per = []
    for s in range(S):
        keep = np.nonzero(flat[s] < n_slots)[0]
        order = keep[np.argsort(flat[s][keep], kind="stable")]
        per.append((order, np.bincount(flat[s][order], minlength=n_slots)))
    deg = max([1] + [int(c.max()) for _o, c in per if c.size])
    inc = np.full((S, n_slots, deg), flat.shape[1], dtype=np.int64)
    for s, (order, counts) in enumerate(per):
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        for k in range(deg):
            has = counts > k
            inc[s, has, k] = order[starts[has] + k]
    return inc


def incidence_sum(vals, inc):
    """Per-shard sums of vals (L, n, k) through inc (L, n_slots, deg):
    (L, n_slots)."""
    L = vals.shape[0]
    flat = torch.cat([vals.reshape(L, -1), vals.new_zeros(L, 1)], dim=1)
    return torch.gather(flat, 1, inc.reshape(L, -1)).reshape(
        inc.shape).sum(dim=2)


def _gather_rows(x, idx):
    """x (L, m) at idx (L, ...) per shard: (L, ...)."""
    L = x.shape[0]
    return torch.gather(x, 1, idx.reshape(L, -1)).reshape(idx.shape)


def _flat(t):
    """(L, n, ...) -> (L*n, ...)."""
    return t.reshape((-1,) + tuple(t.shape[2:]))


class _Scatter:
    """The extended-vector scatter of one per-shard lids table (L, n, k):
    a fixed-fan-in gather + sum over its incidence table, whose last row,
    the trash slot ext_len - 1, reads only the zero slot."""

    def __init__(self, lids_all, ext_len, comm, device):
        inc = shard_incidence(lids_all, ext_len - 1)
        pad = np.full(inc[:, :1].shape, np.asarray(lids_all)[0].size)
        self.inc = comm.local(torch.as_tensor(
            np.concatenate([inc, pad], axis=1), device=device))

    def sum(self, vals):
        return incidence_sum(vals, self.inc)


class DofShardedStep:
    """Residual assembly and Newton steps over a DofPartition: the DOF
    vector sharded, halos through the communicator's ring shifts."""

    def __init__(self, assembler, comm, cg_iters: int = 25):
        self.asm = assembler
        self.comm = comm
        self.cg_iters = cg_iters
        S = comm.n_shards
        self.part = build_dof_partition(assembler, S)
        p, a = self.part, self.part.arrays
        dev, dtype = assembler.device, assembler.dtype

        def put(x, dt=None):
            return comm.local(torch.as_tensor(np.asarray(x), dtype=dt,
                                              device=dev))

        self.lids = put(a["lids"])
        self.signs = put(a["signs"], dtype)
        self.send_next = put(a["send_next"])
        self.send_prev = put(a["send_prev"])
        self.fixed = put(a["fixed"])
        self.valid = put(a["valid"])
        # mixing channel ({} when the discretization has none)
        self.mix = ({} if "mix" not in a else
                    {"p": put(a["mix"]["p"]), "w": put(a["mix"]["w"], dtype),
                     "wT": put(a["mix"]["wT"], dtype)})
        self._vol = _Scatter(a["lids"], p.ext_len, comm, dev)

        # per-shard element data (pad chunk to emax with zero weights)
        cuts, emax = p.cuts, p.emax

        def chunk(x):
            x = np.asarray(x)
            out = np.zeros((S, emax) + x.shape[1:], dtype=x.dtype)
            for s in range(S):
                out[s, :cuts[s + 1] - cuts[s]] = x[cuts[s]:cuts[s + 1]]
            return put(out, dtype if out.dtype.kind == "f" else None)

        def host(t):
            return t.detach().cpu().numpy()

        self.g_ip = chunk(host(assembler.g_ip))
        self.uniform = bool(getattr(assembler, "uniform", False))
        if self.uniform:
            # one shared table; padded elements scaled to zero weight
            self.g_wts = assembler.g_wts
            self.g_bg = assembler.g_bg
            self.e_wscale = put(a["e_valid"].astype(np.float64), dtype)
        else:
            self.g_wts = chunk(host(assembler.g_wts)) * put(
                a["e_valid"].astype(np.float64), dtype)[..., None]
            self.g_bg = tree_map(lambda v: chunk(host(v)), assembler.g_bg)
            self.e_wscale = None

        # boundary groups (weak BCs / natural Dirichlet): partition the
        # boundary elements by their volume element's shard; their dofs
        # are by construction inside that shard's owned+ghost set, so
        # they reuse the same extended vector and halo machinery
        self._groups = []       # (group dict, per-shard arrays)
        masks = None if assembler.module_masks is None \
            else host(assembler.module_masks)
        for group in assembler._active_bnd_groups():
            elems = host(group["elems"])
            shard_of = np.searchsorted(cuts, elems, side="right") - 1
            counts = np.bincount(shard_of, minlength=S)
            bmax = max(int(counts.max()), 1)
            glids = host(group["lids"])
            nb = glids.shape[1]
            B = elems.shape[0]
            lids_g = np.full((S, bmax, nb), p.ext_len - 1, dtype=np.int64)
            signs_g = np.ones((S, bmax, nb))
            gsigns = host(group["signs"])
            bnd_mix = group.get("mixp") is not None
            if bnd_mix:
                gmixp, gmixw = host(group["mixp"]), host(group["mixw"])
                mixp_g = np.tile(np.arange(nb, dtype=np.int64),
                                 (S, bmax, 1))
                mixw_g = np.zeros((S, bmax, nb))
            gw, gip, gn = (host(group[k]) for k in ("wts", "ip", "normals"))
            wts_g = np.zeros((S, bmax) + gw.shape[1:])
            ip_g = np.zeros((S, bmax) + gip.shape[1:])
            nrm_g = np.zeros((S, bmax) + gn.shape[1:])
            nrm_g[..., 0] = 1.0          # safe pad for normalizing code
            gbg = tree_map(host, group["bg"])
            bg_g = tree_map(lambda v: np.zeros((S, bmax) + v.shape[1:],
                                               dtype=v.dtype), gbg)
            # runtime gather index global boundary row -> (S, bmax) (pad
            # -> trash row B): the boundary extra channel (discretized
            # field params at side qps, parameterManager.cpp:272
            # distributes them like state) chunks through it per call
            gidx_g = np.full((S, bmax), B, dtype=np.int64)
            # the per-block physics mask at boundary elements is static
            bm = None if masks is None else masks[elems]
            bmask_g = None if bm is None else np.zeros(
                (S, bmax) + bm.shape[1:], dtype=bm.dtype)
            for s in range(S):
                rows = np.where(shard_of == s)[0]
                if rows.size == 0:
                    continue
                n = rows.size
                gidx_g[s, :n] = rows
                if bmask_g is not None:
                    bmask_g[s, :n] = bm[rows]
                lids_g[s, :n] = p.ext_index(s, glids[rows])
                signs_g[s, :n] = gsigns[rows]
                if bnd_mix:
                    mixp_g[s, :n] = gmixp[rows]
                    mixw_g[s, :n] = gmixw[rows]
                wts_g[s, :n] = gw[rows]
                ip_g[s, :n] = gip[rows]
                nrm_g[s, :n] = gn[rows]

                def fill(dst, src, s=s, rows=rows):
                    dst[s, :rows.size] = src[rows]
                    return dst
                bg_g = tree_map(fill, bg_g, gbg)
            arrays = {
                "lids": put(lids_g), "signs": put(signs_g, dtype),
                "wts": put(wts_g, dtype), "ip": put(ip_g, dtype),
                "normals": put(nrm_g, dtype), "gidx": put(gidx_g),
                "bg": tree_map(lambda v: put(v, dtype), bg_g),
                "mix": ({} if not bnd_mix else
                        {"p": put(mixp_g), "w": put(mixw_g, dtype),
                         "wT": put(np.take_along_axis(mixw_g, mixp_g,
                                                      axis=2), dtype)}),
                "scatter": _Scatter(lids_g, p.ext_len, comm, dev),
            }
            if bmask_g is not None:
                arrays["bmask"] = put(bmask_g, dtype)
            self._groups.append((group, arrays))

        # per-shard element gather for the per-element extra channel
        # (field-param qp values, per-block module masks, mesh data):
        # global (E, ...) arrays -> (S, emax, ...), pad rows -> index E
        E = assembler.lids.shape[0]
        eg = np.full((S, p.emax), E, dtype=np.int64)
        for s in range(S):
            eg[s, :cuts[s + 1] - cuts[s]] = np.arange(cuts[s], cuts[s + 1])
        self.egather = put(eg)

        # owned-dof gather/scatter for global <-> sharded conversion (pad
        # -> trash index n_dof); the scatter reads every shard's table
        own_idx = np.full((S, p.nmax), p.n_dof, dtype=np.int64)
        for s, o in enumerate(p.owned):
            own_idx[s, :len(o)] = o
        self.own_idx_all = torch.as_tensor(own_idx, device=dev)
        self.own_idx = comm.local(self.own_idx_all)

        # multiscale (subgrid DtN) under DOF sharding, both parallelism
        # axes composed (the reference's domain decomposition x
        # 'multiscale split comm', split_mpi_communicators.cpp:31-41,
        # multiscaleManager.cpp:92-140): the fine DtN solves run outside
        # the sharded step on the replicated macro state, and their
        # upscaled residual / flux-Jacobian blocks enter it as owned
        # slices. Each macro block row is assigned to the shard owning
        # its element; its dofs are inside that shard's owned+ghost set,
        # so the blocks ride the same halo machinery as boundary groups.
        self._ms_meta = None
        if assembler.multiscale is not None:
            metas = []
            glids_all = np.asarray(assembler.disc.lids)
            nd_e = glids_all.shape[1]
            for elems in assembler.multiscale.jacobian_block_elems():
                elems = np.asarray(elems)
                shard_of = np.searchsorted(cuts, elems, side="right") - 1
                counts = np.bincount(shard_of, minlength=S)
                bmax = max(int(counts.max()), 1)
                gidx = np.full((S, bmax), len(elems), dtype=np.int64)
                lids_m = np.full((S, bmax, nd_e), p.ext_len - 1,
                                 dtype=np.int64)
                glids = glids_all[elems]
                for s in range(S):
                    rows = np.where(shard_of == s)[0]
                    if rows.size:
                        gidx[s, :rows.size] = rows
                        lids_m[s, :rows.size] = p.ext_index(s, glids[rows])
                metas.append({"gidx": put(gidx), "lids": put(lids_m),
                              "scatter": _Scatter(lids_m, p.ext_len, comm,
                                                  dev)})
            self._ms_meta = metas

    # ---- global <-> sharded conversion -------------------------------

    def gather_global(self, vec):
        """(n_dof,) global vector -> (L, nmax) owned slices held here."""
        vp = torch.cat([vec, vec.new_zeros(1)])
        return vp[self.own_idx]

    def scatter_global(self, arr):
        """(L, nmax) owned slices -> (n_dof,) global vector (every
        shard's slices, gathered through the communicator)."""
        full = self.comm.all_gather(torch.where(self.valid, arr, 0.0))
        out = full.new_zeros(self.part.n_dof + 1)
        out[self.own_idx_all.reshape(-1)] = full.reshape(-1)
        return out[:-1]

    def _ms_inputs(self, u_sh, tc, pvec, want_jac, u_glob=None):
        """Multiscale contributions for one sharded step: {'r': (L, nmax)
        owned-slice residual, 'blocks': [(block chunks (L, bmax, nd, nd),
        ext-indexed lids, scatter)]}, or {} when no multiscale. The fine
        solves see the REPLICATED macro state (rebuilt from the owned
        slices unless the caller holds it: owners partition the dofs)."""
        ms = self.asm.multiscale
        if ms is None or self._ms_meta is None:
            return {}
        if u_glob is None:
            u_glob = self.scatter_global(u_sh)
        if not want_jac:
            return {"r": self.gather_global(
                ms.residual_contribution(u_glob, tc, pvec)), "blocks": []}
        r, blocks = ms.residual_and_blocks(u_glob, tc, pvec)
        out = {"r": self.gather_global(r), "blocks": []}
        for (blk, _lids, _sc), meta in zip(blocks, self._ms_meta):
            bp = torch.cat([blk, blk.new_zeros((1,) + blk.shape[1:])])
            out["blocks"].append((bp[meta["gidx"]], meta["lids"],
                                  meta["scatter"]))
        return out

    def _extra_chunk(self, pvec):
        """The per-element extra channel chunked to (L, emax, ...), or
        None."""
        extra = self.asm._elem_extra(pvec)
        if not extra:
            return None
        eg = self.egather
        return {k: torch.cat([v, v.new_zeros((1,) + v.shape[1:])])[eg]
                for k, v in extra.items()}

    def _bextra_chunk(self, gdict, ga, pvec):
        """Discretized-field-param side-qp values of one active boundary
        group chunked to (L, bmax, ...), or None (the boundary analog of
        `_extra_chunk`; parameterManager.cpp:272 distributes discretized
        params through the same maps as state)."""
        bex = self.asm._bnd_extra(gdict, pvec)
        if not bex:
            return None
        gidx = ga["gidx"]
        return {k: torch.cat([v, v.new_zeros((1,) + v.shape[1:])])[gidx]
                for k, v in bex.items()}

    # ---- per-shard building blocks (leading dim: the shards here) -----

    def _halo_gather(self, u_own):
        """(L, nmax) owned -> (L, ext_len) [owned|gprev|gnext|0] (the
        Import)."""
        z = u_own.new_zeros(u_own.shape[0], 1)
        ut = torch.cat([u_own, z], dim=1)
        gprev = self.comm.shift_next(_gather_rows(ut, self.send_next))
        gnext = self.comm.shift_prev(_gather_rows(ut, self.send_prev))
        return torch.cat([u_own, gprev, gnext, z], dim=1)

    def _halo_reduce(self, seg):
        """(L, ext_len) partial sums -> (L, nmax) owned totals (the
        Export)."""
        p = self.part
        L = seg.shape[0]
        r = torch.cat([seg[:, :p.nmax], seg.new_zeros(L, 1)], dim=1)
        recv_n = self.comm.shift_prev(seg[:, p.nmax:p.nmax + p.gp_max])
        r = r.scatter_add(1, self.send_next, recv_n)
        recv_p = self.comm.shift_next(
            seg[:, p.nmax + p.gp_max:p.nmax + p.gp_max + p.gn_max])
        r = r.scatter_add(1, self.send_prev, recv_p)
        return r[:, :p.nmax]

    def _fold(self, x, signs, mix):
        """Gather-side fold W x of (N, nd) element values."""
        if not self.asm.has_signs:
            return x
        return _fold_W(x, signs, mix.get("p"), mix.get("w"))

    def _local_res_jac(self, u, bu, bt, tc, pvec, ms, want_jac=True):
        """(r (L, nmax), (element blocks (L, emax, nd, nd), [(boundary
        and macro blocks, lids, scatter)])) of the shards held here; r
        has zero Dirichlet and pad rows."""
        asm = self.asm
        L, emax = self.lids.shape[:2]
        ext = [self._halo_gather(v) for v in (u, bu, bt)]
        flat_mix = {k: _flat(v) for k, v in self.mix.items()}
        signs = _flat(self.signs)
        ue, bue, bte = (self._fold(_flat(_gather_rows(x, self.lids)),
                                   signs, flat_mix) for x in ext)
        fn = asm._elem_fn(tc, pvec)
        if self.uniform:
            # padded elements' residuals scale to zero with the weights
            wts = self.g_wts.expand((L * emax,) + self.g_wts.shape) \
                * _flat(self.e_wscale)[:, None]
            bg, gax = self.g_bg, None
        else:
            wts, bg, gax = _flat(self.g_wts), tree_map(_flat, self.g_bg), 0
        extra = self._extra_chunk(pvec)
        eax = None
        if extra is not None:
            extra, eax = {k: _flat(v) for k, v in extra.items()}, 0
        in_dims = (0, 0, 0, 0, 0, gax, eax)
        args = (ue, bue, bte, wts, _flat(self.g_ip), bg, extra)
        res_e = torch.func.vmap(fn, in_dims=in_dims)(*args)
        jac_e = None
        if want_jac:
            jac_e = torch.func.vmap(torch.func.jacfwd(fn, argnums=0),
                                    in_dims=in_dims)(*args)
        if asm.has_signs:
            res_e = _fold_WT(res_e, signs, flat_mix.get("p"),
                             flat_mix.get("wT"))
            if want_jac:
                jac_e = _fold_jac_WT_W(jac_e, signs, flat_mix.get("p"),
                                       flat_mix.get("wT"))
        nd = res_e.shape[-1]
        seg = self._vol.sum(res_e.reshape(L, emax, nd))

        # boundary groups: gather from the SAME extended vector,
        # accumulate into the SAME pre-Export partial sums
        bnd_jacs = []
        for gdict, ga in self._groups:
            glids = ga["lids"]
            nb_rows = glids.shape[1]
            gsigns = _flat(ga["signs"])
            gmix = {k: _flat(v) for k, v in ga["mix"].items()}
            ub, bub, btb = (self._fold(_flat(_gather_rows(x, glids)),
                                       gsigns, gmix) for x in ext)
            bfn = asm._bnd_fn(gdict, tc, pvec)
            bex = self._bextra_chunk(gdict, ga, pvec)
            bm = ga.get("bmask")
            bax = (0,) * 7 + (None if bm is None else 0,
                              None if bex is None else 0)
            bargs = (ub, bub, btb, _flat(ga["wts"]), _flat(ga["ip"]),
                     _flat(ga["normals"]), tree_map(_flat, ga["bg"]),
                     None if bm is None else _flat(bm),
                     None if bex is None else tree_map(_flat, bex))
            res_b = torch.func.vmap(bfn, in_dims=bax)(*bargs)
            if asm.has_signs:
                res_b = _fold_WT(res_b, gsigns, gmix.get("p"),
                                 gmix.get("wT"))
            seg = seg + ga["scatter"].sum(res_b.reshape(L, nb_rows, -1))
            if want_jac:
                jac_b = torch.func.vmap(torch.func.jacfwd(bfn, argnums=0),
                                        in_dims=bax)(*bargs)
                if asm.has_signs:
                    jac_b = _fold_jac_WT_W(jac_b, gsigns, gmix.get("p"),
                                           gmix.get("wT"))
                k = jac_b.shape[-1]
                bnd_jacs.append((jac_b.reshape(L, nb_rows, k, k), glids,
                                 ga["scatter"]))

        r = self._halo_reduce(seg)
        if ms:
            # upscaled subgrid residual: assembled globally outside the
            # sharded step, enters as this shard's owned slice; its
            # flux-Jacobian blocks ride the boundary-group channel
            r = r + ms["r"]
            if want_jac:
                bnd_jacs += ms["blocks"]
        r = torch.where(self.fixed, 0.0, torch.where(self.valid, r, 0.0))
        if want_jac:
            jac_e = jac_e.reshape(L, emax, nd, nd)
        return r, (jac_e, bnd_jacs)

    def _build_apply_diag(self, jac_e, bnd_jacs):
        """Matrix-free J-apply + Jacobi diagonal from local blocks."""
        fixed, valid = self.fixed, self.valid

        def apply(v):
            vm = torch.where(fixed, 0.0, v)
            ext_v = self._halo_gather(vm)
            seg = self._vol.sum(torch.einsum(
                "leij,lej->lei", jac_e, _gather_rows(ext_v, self.lids)))
            for jac_b, glids, sc in bnd_jacs:
                seg = seg + sc.sum(torch.einsum(
                    "leij,lej->lei", jac_b, _gather_rows(ext_v, glids)))
            av = self._halo_reduce(seg)
            return torch.where(fixed, v, torch.where(valid, av, 0.0))

        dseg = self._vol.sum(torch.diagonal(jac_e, dim1=2, dim2=3))
        for jac_b, _glids, sc in bnd_jacs:
            dseg = dseg + sc.sum(torch.diagonal(jac_b, dim1=2, dim2=3))
        diag = self._halo_reduce(dseg)
        dinv = torch.where(fixed | ~valid, 1.0,
                           1.0 / torch.where(diag == 0, 1.0, diag))
        return apply, dinv

    def dot(self, a, b):
        """Sum over every shard of a * b's valid entries: a per-shard
        partial sum, then psum. a may carry leading batch axes (k, L,
        nmax): the result is then (k,)."""
        part = torch.where(self.valid, a * b, 0.0).sum(dim=-1)
        return self.comm.psum(part.movedim(-1, 0))

    @staticmethod
    def _cg(apply, b, dinv, dot, iters):
        """Fixed-iteration Jacobi-preconditioned CG from x = 0."""
        x = torch.zeros_like(b)
        rr = b
        z = dinv * rr
        pv = z
        num = dot(rr, z)
        for _ in range(iters):
            Ap = apply(pv)
            den = dot(pv, Ap)
            alpha = num / torch.where(den == 0, 1.0, den)
            x = x + alpha * pv
            rr = rr - alpha * Ap
            z = dinv * rr
            num1 = dot(rr, z)
            beta = num1 / torch.where(num == 0, 1.0, num)
            num, pv = num1, z + beta * pv
        return x

    @staticmethod
    def _gmres(apply, b, dinv, dot, m, restarts):
        """GMRES(m) with `restarts` cycles, Jacobi right-preconditioned:
        classical Gram-Schmidt against the whole basis (the rows not yet
        built are zero) with psum-backed inner products, then the
        minimal-norm least-squares solution of the Hessenberg system
        (solvers/krylov.gmres_fixed's pseudo-inverse, JAX's lstsq)."""
        x = torch.zeros_like(b)
        rows = torch.arange(m + 1, device=b.device)
        for _ in range(restarts):
            r0 = b - apply(x)
            beta = torch.sqrt(dot(r0, r0))
            V = b.new_zeros((m + 1,) + tuple(b.shape))
            V[0] = r0 / torch.where(beta > 0, beta, 1.0)
            H = b.new_zeros((m + 1, m))
            for j in range(m):
                w = apply(dinv * V[j])
                hcol = torch.where(rows <= j, dot(V, w), 0.0)
                w = w - torch.tensordot(hcol, V, dims=1)
                hnorm = torch.sqrt(dot(w, w))
                V[j + 1] = w / torch.where(hnorm > 0, hnorm, 1.0)
                hcol[j + 1] = hnorm
                H[:, j] = hcol
            g = b.new_zeros(m + 1)
            g[0] = beta
            y = torch.linalg.pinv(H) @ g
            x = x + dinv * torch.tensordot(y, V[:m], dims=1)
        return x

    # ---- public API ---------------------------------------------------

    def residual(self, u, bu, bt, tc, pvec=None, u_glob=None):
        """The sharded residual (L, nmax) at owned slices u, bu, bt (tc's
        beta vectors are read only by a multiscale model's fine solves,
        which see the global state)."""
        ms = self._ms_inputs(u, tc, pvec or {}, False, u_glob)
        return self._local_res_jac(u, bu, bt, tc, pvec, ms,
                                   want_jac=False)[0]

    def residual_fn(self, pvec=None):
        """(u_sh, bu_sh, bt_sh, tc) -> r_sh."""
        return lambda u, bu, bt, tc: self.residual(u, bu, bt, tc, pvec)

    def residual_arg_fn(self, pvec_struct=()):
        """(u_sh, bu_sh, bt_sh, tc, pvec) -> r_sh: pvec as an argument."""
        return lambda u, bu, bt, tc, pvec: self.residual(u, bu, bt, tc,
                                                         pvec)

    def res_and_operator(self, u, bu, bt, tc, pvec=None, u_glob=None):
        """(r_sh, apply, dinv) of one Newton step."""
        ms = self._ms_inputs(u, tc, pvec or {}, True, u_glob)
        r, (jac_e, bnd_jacs) = self._local_res_jac(u, bu, bt, tc, pvec, ms)
        apply, dinv = self._build_apply_diag(jac_e, bnd_jacs)
        return r, apply, dinv

    def solve(self, apply, rhs, dinv, method="cg", iters=25, gmres_m=40,
              gmres_restarts=2):
        """The fixed-count sharded Krylov solve: Jacobi CG for "cg",
        GMRES(gmres_m) x gmres_restarts otherwise."""
        if method == "cg":
            return self._cg(apply, rhs, dinv, self.dot, iters)
        return self._gmres(apply, rhs, dinv, self.dot, gmres_m,
                           gmres_restarts)

    def newton_cg_step_fn(self, pvec=None):
        """One full implicit step: assemble J, r; Jacobi-CG solve; update.
        (u_sh, bu_sh, bt_sh, tc) -> (u_sh', |r|)."""
        def step(u, bu, bt, tc):
            r, apply, dinv = self.res_and_operator(u, bu, bt, tc, pvec)
            x = self._cg(apply, -r, dinv, self.dot, self.cg_iters)
            return u + x, torch.sqrt(self.dot(r, r))
        return step

    def newton_du_fn(self, pvec_struct=(), method="cg", iters=25,
                     gmres_m=40, gmres_restarts=2):
        """The sharded Newton LINEAR step of the deck driver: (u_sh,
        bu_sh, bt_sh, tc, pvec) -> (du_sh, |r|)."""
        def step(u, bu, bt, tc, pvec):
            r, apply, dinv = self.res_and_operator(u, bu, bt, tc, pvec)
            du = self.solve(apply, -r, dinv, method, iters, gmres_m,
                            gmres_restarts)
            return du, torch.sqrt(self.dot(r, r))
        return step
