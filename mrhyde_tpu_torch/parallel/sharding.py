"""Distribution v1, "replicated": elements sharded, the DOF vector
replicated, a partial segment-sum per shard and then an all-reduce.

The port of the JAX package's `mrhyde_tpu/parallel/sharding.py` (the
"replicated-assembly + psum" design of SURVEY.md section 5.8; reference
src/interfaces/linearAlgebraInterface.cpp:145-309): the padded element
array is cut into equal per-shard chunks, each shard assembles its
elements' residual and Jacobian blocks into a partial sum over the whole
DOF vector, and `psum` adds the partials, so every shard holds the
replicated residual. Boundary groups are O(surface) and assembled
replicated; a multiscale deck's fine solves are spread over the shards
by `SubgridDtN.enable_device_sharding`. The communicator
(parallel/comm.py) is the choice that `make_mesh` was: `make_comm`.
"""

from __future__ import annotations

import numpy as np
import torch

from mrhyde_tpu_torch.assembly.assembler import (_fold_W, _fold_WT,
                                                 _fold_jac_WT_W)
from mrhyde_tpu_torch.parallel.comm import ProcessGroupComm, StackedComm
from mrhyde_tpu_torch.parallel.dof_sharding import (DofShardedStep,
                                                    incidence_sum,
                                                    shard_incidence)

__all__ = ["make_comm", "pad_elements", "shard_assembler_arrays",
           "sharded_newton_cg_step", "sharded_newton_du_step"]


def make_comm(n_shards: int, distributed: bool = False, group=None):
    """The communicator of n_shards shards: a StackedComm, or with
    `distributed` a ProcessGroupComm over the initialised process group
    (which must hold n_shards ranks)."""
    if not distributed:
        return StackedComm(n_shards)
    comm = ProcessGroupComm(group)
    if comm.n_shards != n_shards:
        raise ValueError(f"{n_shards} shards asked for, but the process "
                         f"group holds {comm.n_shards} ranks")
    return comm


def pad_elements(n_elem: int, n_shards: int) -> int:
    """Elements after padding to an even split."""
    return -(-n_elem // n_shards) * n_shards


def _padded(x, Epad, fill=0):
    """x (E, ...) numpy padded to (Epad, ...) with `fill`."""
    x = np.asarray(x)
    out = np.full((Epad,) + x.shape[1:], fill, dtype=x.dtype)
    out[:x.shape[0]] = x
    return out


def shard_assembler_arrays(assembler, comm):
    """The assembler's per-element arrays padded to an even split and cut
    into (S, E/S, ...) chunks, the rows held here kept. Padding elements
    index a dummy dof (n_dof), whose sum is dropped, and get zero
    quadrature weights on non-uniform meshes."""
    S = comm.n_shards
    E = assembler.lids.shape[0]
    Epad = pad_elements(E, S)
    dev, dt = assembler.device, assembler.dtype

    def put(x, dtype=None):
        t = torch.as_tensor(x, dtype=dtype, device=dev)
        return comm.local(t.reshape((S, Epad // S) + t.shape[1:]))

    def host(t):
        return t.detach().cpu().numpy()

    lids = _padded(assembler.disc.lids, Epad, fill=assembler.n_dof)
    uniform = bool(getattr(assembler, "uniform", False))
    arrays = {"lids": put(lids), "ip": put(_padded(host(assembler.g_ip),
                                                   Epad), dt),
              "uniform": uniform, "E": E, "Epad": Epad,
              "inc": comm.local(torch.as_tensor(shard_incidence(
                  lids.reshape(S, Epad // S, -1), assembler.n_dof),
                  device=dev))}
    if uniform:
        # compressed basis database: one shared table
        arrays["wts"], arrays["bg"] = assembler.g_wts, assembler.g_bg
    else:
        from torch.utils._pytree import tree_map
        arrays["wts"] = put(_padded(host(assembler.g_wts), Epad), dt)
        arrays["bg"] = tree_map(lambda v: put(_padded(host(v), Epad), dt),
                                assembler.g_bg)
    return arrays


def _spmd_assemble_builder(assembler, comm):
    """Element-sharded assembly shared by the v1 step builders.

    Returns (assemble, arrays) where assemble(u, tc, pvec, want_jac) ->
    (r, apply, dinv): the replicated global residual, the matrix-free
    J-apply over the sharded element blocks, and the Jacobi diagonal
    inverse (apply and dinv None when want_jac=False). Covers orientation
    signs and the tet-HCURL >= 2 mixing channel, the per-element extra
    channel (field params, block masks), boundary groups, and multiscale
    decks (fine solves spread over the shards).
    """
    from torch.utils._pytree import tree_map
    arrays = shard_assembler_arrays(assembler, comm)
    n_dof = assembler.n_dof
    fixed = assembler.fixed
    if assembler.multiscale is not None:
        assembler.multiscale.enable_device_sharding(comm)
    S, E, Epad = comm.n_shards, arrays["E"], arrays["Epad"]
    dev, dt = assembler.device, assembler.dtype
    gax = None if arrays["uniform"] else 0

    def put(x, dtype=None):
        t = torch.as_tensor(x, dtype=dtype, device=dev)
        return comm.local(t.reshape((S, Epad // S) + t.shape[1:]))

    # orientation fold channel, padded (pad rows: signs 1, mix with self
    # at weight 0)
    signs = mixp = mixw = mixwT = None
    if assembler.has_signs:
        dm = assembler.disc.dofmap
        nd = assembler.lids.shape[1]
        signs = put(_padded(dm.signs, Epad, 1.0), dt)
        if dm.mix_pair is not None:
            mp = np.tile(np.arange(nd, dtype=np.int64), (Epad, 1))
            mw = np.zeros((Epad, nd))
            mp[:E] = dm.mix_pair
            mw[:E] = dm.mix_w
            mixp, mixw = put(mp), put(mw, dt)
            mixwT = put(np.take_along_axis(mw, mp, axis=1), dt)

    def flat(t):
        return None if t is None else t.reshape((-1,) + t.shape[2:])

    lids, inc = arrays["lids"], arrays["inc"]
    L = lids.shape[0]

    def partial_sum(vals):
        """(L, n, k) element values -> replicated (n_dof,)."""
        return comm.psum(incidence_sum(vals, inc))

    def assemble(u, tc, pvec=None, want_jac=True):
        fs, fp, fw, fwT = flat(signs), flat(mixp), flat(mixw), flat(mixwT)

        def gath(vec):
            g = flat(torch.cat([vec, vec.new_zeros(1)])[lids])
            return g if fs is None else _fold_W(g, fs, fp, fw)

        u_e, bu_e, bt_e = gath(u), gath(tc.beta_u), gath(tc.beta_t)
        fn = assembler._elem_fn(tc, pvec)
        extra = assembler._elem_extra(pvec)
        eax = None
        if extra is not None:
            extra = {k: flat(put(_padded_t(v, Epad)))
                     for k, v in extra.items()}
            eax = 0
        wts = arrays["wts"] if gax is None else flat(arrays["wts"])
        bg = arrays["bg"] if gax is None else tree_map(flat, arrays["bg"])
        in_dims = (0, 0, 0, gax, 0, gax, eax)
        args = (u_e, bu_e, bt_e, wts, flat(arrays["ip"]), bg, extra)
        res_e = torch.func.vmap(fn, in_dims=in_dims)(*args)
        jac_e = torch.func.vmap(torch.func.jacfwd(fn, argnums=0),
                                in_dims=in_dims)(*args) \
            if want_jac else None
        if fs is not None:
            res_e = _fold_WT(res_e, fs, fp, fwT)
            if want_jac:
                jac_e = _fold_jac_WT_W(jac_e, fs, fp, fwT)
        nd = res_e.shape[-1]
        r = partial_sum(res_e.reshape(L, -1, nd))

        # boundary groups (weak BCs / natural Dirichlet): O(surface),
        # assembled replicated, added once to the replicated residual
        bnd = {"bnd": [], "bnd_lids": [], "bnd_scatter": []}
        if assembler._active_bnd_groups():
            r = r + assembler._bnd_res_scatter(u, tc, pvec)
            if want_jac:
                bnd = assembler._bnd_jac_parts(u, tc, pvec)
        bnd_jacs = list(zip(bnd["bnd"], bnd["bnd_lids"], bnd["bnd_scatter"]))

        # multiscale: upscaled subgrid contributions from the fine solves,
        # spread over the shards (SubgridDtN.enable_device_sharding)
        ms = assembler.multiscale
        if ms is not None:
            if want_jac:
                r_ms, blocks = ms.residual_and_blocks(u, tc, pvec)
                bnd_jacs += blocks
            else:
                r_ms = ms.residual_contribution(u, tc, pvec)
            r = r + r_ms
        r = torch.where(fixed, 0.0, r)
        if not want_jac:
            return r, None, None
        jac_e = jac_e.reshape(L, -1, nd, nd)

        def apply(v):
            # jac_e is already folded to the canonical frame (W^T J W),
            # so the gather here is raw: no sign or mixing fold
            vm = torch.where(fixed, 0.0, v)
            ve = torch.cat([vm, vm.new_zeros(1)])[lids]
            av = partial_sum(torch.einsum("leij,lej->lei", jac_e, ve))
            for blocks, blids, sc in bnd_jacs:
                av = sc.add(av, torch.einsum("eij,ej->ei", blocks,
                                             vm[blids]))
            return torch.where(fixed, v, av)

        diag = partial_sum(torch.diagonal(jac_e, dim1=2, dim2=3))
        for blocks, _blids, sc in bnd_jacs:
            diag = sc.add(diag, torch.diagonal(blocks, dim1=1, dim2=2))
        dinv = torch.where(fixed, 1.0,
                           1.0 / torch.where(diag == 0, 1.0, diag))
        return r, apply, dinv

    return assemble, arrays


def _padded_t(t, Epad):
    """A per-element tensor (E, ...) padded with zero rows to Epad."""
    pad = Epad - t.shape[0]
    return t if pad == 0 else torch.cat(
        [t, t.new_zeros((pad,) + t.shape[1:])])


def _vdot(a, b):
    """The dot product of replicated vectors (a may carry a leading batch
    axis)."""
    return (a * b).sum(dim=-1)


def sharded_newton_cg_step(assembler, comm, cg_iters: int = 25):
    """An element-sharded Newton-CG step: u -> (u', |r|).

    One full implicit step: assemble the element-block Jacobian and the
    residual over sharded elements, then a fixed-iteration
    Jacobi-preconditioned CG on the matrix-free operator. Returns (step,
    arrays)."""
    assemble, arrays = _spmd_assemble_builder(assembler, comm)

    def step(u, tc, pvec=None):
        r, apply, dinv = assemble(u, tc, pvec)
        x = DofShardedStep._cg(apply, -r, dinv, _vdot, cg_iters)
        return u + x, torch.linalg.norm(r)

    return step, arrays


def sharded_newton_du_step(assembler, comm, method: str = "cg",
                           iters: int = 200, gmres_m: int = 60,
                           gmres_restarts: int = 4):
    """The deck-facing element-sharded Newton LINEAR step and residual
    norm: (du_fn, res_norm_fn). du_fn(u, tc, pvec) -> (du, |r|) assembles
    the sharded residual and Jacobian (with a multiscale deck's upscaled
    blocks) and runs fixed-iteration Jacobi CG or restarted GMRES;
    res_norm_fn(u, tc, pvec) -> |r| is the residual-only path of the
    backtracking line search."""
    assemble, _arrays = _spmd_assemble_builder(assembler, comm)

    def du_step(u, tc, pvec=None):
        r, apply, dinv = assemble(u, tc, pvec)
        if method == "cg":
            du = DofShardedStep._cg(apply, -r, dinv, _vdot, iters)
        else:
            du = DofShardedStep._gmres(apply, -r, dinv, _vdot, gmres_m,
                                       gmres_restarts)
        return du, torch.linalg.norm(r)

    def res_norm(u, tc, pvec=None):
        return torch.linalg.norm(assemble(u, tc, pvec, want_jac=False)[0])

    return du_step, res_norm
