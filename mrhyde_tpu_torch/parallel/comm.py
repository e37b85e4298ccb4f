"""The shard communicator: the port's counterpart of shard_map's
`ppermute` ring shifts and `psum`.

The sharded steps (parallel/dof_sharding.py, parallel/sharding.py) are
written once, against tensors whose leading dimension is "the shards
held here", and three operations on them:

- shift_next(x): shard s's rows go to shard s+1; shard 0 receives zeros
  (`ppermute` with the permutation [(i, i+1)]);
- shift_prev(x): shard s's rows go to shard s-1; the last shard receives
  zeros;
- psum(x): the sum over every shard of x's per-shard rows, which every
  shard sees;

plus all_gather(x), which stacks every shard's rows in shard order (the
owned slices of a vector back into the replicated one).

StackedComm holds all S shards stacked in dim 0 of one tensor on one
device (the counterpart of N virtual devices on one host): a shift is a
slice and a zero row, psum a sum over dim 0. ProcessGroupComm holds one
shard per torch.distributed rank: shifts are batch_isend_irecv with the
ranks s +- 1, psum is all_reduce(SUM) (gloo on CPU tensors, NCCL on CUDA
tensors). Neither falls back to the other.
"""

from __future__ import annotations

import torch

__all__ = ["StackedComm", "ProcessGroupComm"]


class StackedComm:
    """All n_shards shards in one process, stacked in dim 0."""

    def __init__(self, n_shards: int):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)

    def local(self, table):
        """The rows of a per-shard table (S, ...) held here: all."""
        return table

    @staticmethod
    def _pad0(x, before, after):
        # zero rows before / after dim 0, one launch
        return torch.nn.functional.pad(
            x, (0, 0) * (x.dim() - 1) + (before, after))

    def shift_next(self, x):
        return self._pad0(x[:-1], 1, 0)

    def shift_prev(self, x):
        return self._pad0(x[1:], 0, 1)

    def psum(self, x):
        return x.sum(dim=0)

    def all_gather(self, x):
        return x


class ProcessGroupComm:
    """One shard per rank of a torch.distributed process group (the
    default group unless one is given); the group must be initialised."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ProcessGroupComm needs an initialised torch.distributed "
                "process group (torch.distributed.init_process_group, or "
                "a torchrun launch)")
        self._dist = dist
        self.group = group if group is not None else dist.group.WORLD
        self.n_shards = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)

    def local(self, table):
        """This rank's row of a per-shard table (S, ...), as (1, ...)."""
        return table[self.rank:self.rank + 1]

    def _global(self, r):
        return self._dist.get_global_rank(self.group, r) \
            if self.group is not self._dist.group.WORLD else r

    def _shift(self, x, to, frm):
        dist = self._dist
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        if 0 <= to < self.n_shards:
            ops.append(dist.P2POp(dist.isend, x, self._global(to),
                                  self.group))
        if 0 <= frm < self.n_shards:
            ops.append(dist.P2POp(dist.irecv, out, self._global(frm),
                                  self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def shift_next(self, x):
        return self._shift(x, self.rank + 1, self.rank - 1)

    def shift_prev(self, x):
        return self._shift(x, self.rank - 1, self.rank + 1)

    def psum(self, x):
        out = x.sum(dim=0).contiguous()
        self._dist.all_reduce(out, op=self._dist.ReduceOp.SUM,
                              group=self.group)
        return out

    def all_gather(self, x):
        parts = [torch.empty_like(x) for _ in range(self.n_shards)]
        self._dist.all_gather(parts, x.contiguous(), group=self.group)
        return torch.cat(parts)
