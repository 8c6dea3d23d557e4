"""A rank's slice of the particle axis, and the collectives of the filter's
boundaries.

The particle split (``parallel.sharded_filter_step``) gives each rank of a
process group an equal, contiguous slice of the capacity.  Per-particle
work runs on the slice; the sums of the filter's boundaries (weight
normalization, entropy, pose moments, covariance) go through
``all_reduce``, and the resampling CDF sees every slice through
``all_gather``.  The functions of ``pf`` and ``state`` that reduce over
particles take an optional ``Shard``; without one they compute what they
compute alone, to the bit.

Every rank must reach the same collectives in the same order, so none of
them sits inside a branch a rank takes on its own (a measurement tier, a
march that exits early on the host).
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional

import torch
import torch.distributed as dist


class Shard(NamedTuple):
    """This rank's slice: slots ``offset .. offset + local capacity`` of a
    capacity of ``capacity`` slots split evenly over ``group``."""

    group: Any            # torch.distributed ProcessGroup (None: the default)
    offset: int           # global slot of the slice's first particle
    capacity: int         # the whole capacity, every slice together

    def sum(self, *ts):
        """Each of ``ts`` summed over the ranks, in one ``all_reduce``."""
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=self.group)
        out, off = [], 0
        for t in ts:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return tuple(out)

    def reduce(self, t, op):
        t = t.clone()
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def max(self, t):
        return self.reduce(t, dist.ReduceOp.MAX)

    def min(self, t):
        return self.reduce(t, dist.ReduceOp.MIN)

    def gather(self, t):
        """Every rank's ``t`` concatenated along dim 0, in rank order."""
        t = t.contiguous()
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(self.group))]
        dist.all_gather(parts, t, group=self.group)
        return torch.cat(parts)

    def local(self, t):
        """This slice's rows of a whole-capacity tensor ``t``."""
        n = self.capacity // dist.get_world_size(self.group)
        return t[self.offset:self.offset + n]


def offset(shard: Optional[Shard]) -> int:
    return 0 if shard is None else shard.offset


def total(x, shard: Optional[Shard] = None):
    """``torch.sum(x)``, over every slice with a shard."""
    s = torch.sum(x)
    return s if shard is None else shard.sum(s)[0]
