"""One axis of the lattice work split over the ranks of a mesh axis.

The port's counterpart of what the JAX package leaves to ``shard_map`` (the
builder's tap-sharded probes) and to GSPMD (the vertex-sharded stencil
ops): eager PyTorch partitions explicitly.  An axis of n entries is padded
to a multiple of the rank count R with a fill that computes nothing real,
rank r takes entries ``[r * ceil(n / R), (r + 1) * ceil(n / R))``, and an
all-gather over the mesh axis' process group puts the parts back in rank
order, the padding trimmed.  The split and the gather themselves change
no value: an entry computed row by row, as a probe or a stencil kernel's
output row is, comes back as unsplit, while an op that reduces over the
split axis, or a GEMM on a subset of the rows, may round otherwise.

The collectives run on the group's backend: NCCL between cards, gloo on
the CPU or for ranks sharing one card (gloo takes CUDA tensors).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
import torch.distributed as dist

__all__ = ["AxisShard", "axis_shard", "local_part", "gather_parts"]


class AxisShard(NamedTuple):
    group: Any    # the process group of the mesh axis
    rank: int     # this rank's index on the axis
    world: int    # ranks on the axis

    def per_rank(self, n: int) -> int:
        """Entries each rank takes of an axis of ``n`` (padding included)."""
        return -(-n // self.world)


def axis_shard(mesh, axis: str) -> AxisShard | None:
    """This rank's place on ``mesh``'s ``axis``; None when there is nothing
    to split (one rank on the axis, or a mesh without a process group)."""
    world = mesh.shape[axis]
    group = mesh.group(axis)
    if world == 1 or group is None:
        return None
    return AxisShard(group, mesh.coordinate()[axis], world)


def local_part(x: torch.Tensor, dim: int, fill, shard: AxisShard) -> torch.Tensor:
    """This rank's contiguous part of ``x`` along ``dim``, the axis first
    padded with ``fill`` to a multiple of the rank count."""
    n = x.shape[dim]
    per = shard.per_rank(n)
    pad = per * shard.world - n
    if pad:
        shape = list(x.shape)
        shape[dim] = pad
        x = torch.cat([x, x.new_full(shape, fill)], dim)
    return x.narrow(dim, shard.rank * per, per).contiguous()


def gather_parts(local: torch.Tensor, n: int, shard: AxisShard) -> torch.Tensor:
    """Every rank's part of a leading axis of ``n`` entries, in rank order,
    with the padding trimmed (the inverse of :func:`local_part` along
    dim 0)."""
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(shard.world)]
    dist.all_gather(parts, local, group=shard.group)
    return torch.cat(parts)[:n]
