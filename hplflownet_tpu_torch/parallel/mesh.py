"""Named-axes meshes over the ranks of a ``torch.distributed`` job.

Port of ``hplflownet_tpu/parallel/mesh.py``.  A JAX mesh arranges devices;
in the port one process drives one device, so a mesh arranges ranks.  With
a process group the mesh carries a ``torch.distributed`` ``DeviceMesh``,
whose per-axis groups the collectives use.  Without one (a single process
that never called ``parallel.initialize``) it is a plain named-axes array
of the one rank, and no collective runs.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch.distributed as dist

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """Ranks laid out row-major on named axes.

    ``shape`` maps each axis name to its size, in order; ``ranks`` is the
    array of ranks; ``device_mesh`` the ``DeviceMesh`` when a process group
    exists, else None.
    """

    def __init__(self, ranks: np.ndarray, axis_names: Sequence[str],
                 device_mesh=None):
        self.ranks = np.asarray(ranks)
        self.axis_names = tuple(axis_names)
        self.device_mesh = device_mesh
        self.shape = dict(zip(self.axis_names, self.ranks.shape))

    @property
    def size(self) -> int:
        return int(self.ranks.size)

    def coordinate(self, rank: int | None = None) -> dict:
        """``rank``'s index on each axis (this process's rank by default)."""
        if rank is None:
            rank = dist.get_rank() if dist.is_initialized() else 0
        where = np.argwhere(self.ranks == rank)
        if len(where) != 1:
            raise ValueError(f"rank {rank} is not on the mesh {self.shape}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def group(self, axis: str):
        """The process group of this rank's peers along ``axis``, or None
        without a process group (a single process: nothing to reduce)."""
        if axis not in self.shape:
            raise KeyError(f"no axis {axis!r} on the mesh {self.shape}")
        if self.device_mesh is None:
            return None
        return self.device_mesh.get_group(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape})"


def make_mesh(axis_sizes: Sequence[int] | None = None,
              axis_names: Sequence[str] = ("data",)) -> Mesh:
    """A mesh over every rank of the job (the one process without a group).

    ``axis_sizes=None`` puts every rank on the first axis.  The product of
    the sizes must equal the world size.  Ranks are laid out row-major, so
    the ranks of one host, which launchers number contiguously, stay
    neighbours along the first axis.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    axis_names = tuple(axis_names)
    if axis_sizes is None:
        axis_sizes = (world,) + (1,) * (len(axis_names) - 1)
    axis_sizes = tuple(int(s) for s in axis_sizes)
    if len(axis_sizes) != len(axis_names):
        raise ValueError(f"{len(axis_sizes)} axis sizes for {len(axis_names)} "
                         f"names {axis_names}")
    if int(np.prod(axis_sizes)) != world:
        raise ValueError(f"mesh {axis_sizes} != {world} ranks")
    ranks = np.arange(world).reshape(axis_sizes)
    device_mesh = None
    if dist.is_initialized():
        from torch.distributed.device_mesh import init_device_mesh
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
        device_mesh = init_device_mesh(device_type, axis_sizes,
                                       mesh_dim_names=axis_names)
    return Mesh(ranks, axis_names, device_mesh)
