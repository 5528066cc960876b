"""Multi-process initialization and the global mesh.

Port of ``hplflownet_tpu/parallel/distributed.py`` onto
``torch.distributed``: one process per device, each a rank of one job.

* :func:`initialize` joins the job: with an explicit coordinator, or from
  the environment that ``torchrun`` or SLURM set up.  It sets the rank's
  current CUDA device and picks NCCL on the card, gloo on the CPU.
* :func:`global_mesh` is the ``(data, lattice)`` mesh over every rank,
  each host's ranks contiguous on ``data``.
* :func:`process_local_batch_slice` is the part of the global batch this
  rank loads; the data loader feeds only that slice.

A single process never needs :func:`initialize`; every helper then works
on the one rank.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

from ..device import resolve_device
from .mesh import Mesh, make_mesh

__all__ = ["initialize", "global_mesh", "process_local_batch_slice"]


def _cluster_env():
    """(init_method, rank, world size, local rank) from a launcher's
    environment, or None outside a multi-process job."""
    env = os.environ
    if all(env.get(k) for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        rank = int(env["RANK"])
        return "env://", rank, int(env["WORLD_SIZE"]), int(env.get("LOCAL_RANK", rank))
    if env.get("SLURM_JOB_ID") and int(env.get("SLURM_NTASKS", "1")) > 1:
        if not (env.get("MASTER_ADDR") and env.get("MASTER_PORT")):
            raise RuntimeError(
                "a SLURM job of several tasks needs MASTER_ADDR and MASTER_PORT "
                "exported (the first task's host and a free port)")
        rank = int(env["SLURM_PROCID"])
        return ("env://", rank, int(env["SLURM_NTASKS"]),
                int(env.get("SLURM_LOCALID", rank)))
    return None


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None,
               device=None, timeout: float | None = None):
    """Join a multi-process job; -> this rank's device, or None when there
    is no job to join.

    With no coordinator the call does nothing unless a launcher's
    environment is present (``torchrun``'s ``RANK`` / ``WORLD_SIZE`` /
    ``MASTER_ADDR``, or a SLURM job of several tasks).  An explicit
    ``coordinator_address`` ("host:port", rank 0's host) needs
    ``num_processes`` and ``process_id``, and every failure propagates: a
    rank that cannot join must fail rather than train a private copy.

    ``device`` is "cpu" or a CUDA device; by default the card numbered by
    the local rank (modulo the cards present), made the current CUDA
    device.  ``backend`` defaults to NCCL on the card and gloo on the CPU.
    ``timeout`` (seconds) bounds the rendezvous and every collective.
    """
    if dist.is_initialized():
        return None
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("an explicit coordinator_address needs "
                             "num_processes and process_id")
        host, sep, port = coordinator_address.rpartition(":")
        if not (sep and host and port.isdigit()):
            raise ValueError(f"coordinator_address {coordinator_address!r} "
                             "is not host:port")
        init_method = f"tcp://{coordinator_address}"
        rank, world, local = int(process_id), int(num_processes), int(process_id)
    else:
        found = _cluster_env()
        if found is None:
            return None
        init_method, rank, world, local = found
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside a job of {world}")

    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    else:
        if device is None and torch.cuda.is_available():
            device = torch.device("cuda", local % torch.cuda.device_count())
        dev = resolve_device(device)
        torch.cuda.set_device(dev)
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"),
                            init_method=init_method, world_size=world,
                            rank=rank, **kwargs)
    return dev


def global_mesh(data_axis: int | None = None, lattice_axis: int = 1) -> Mesh:
    """The ``(data, lattice)`` mesh over every rank of the job.

    Pure data parallelism over every rank by default.  Ranks are laid out
    row-major, so a host's ranks (contiguous numbers) stay neighbours along
    ``data`` and the gradient sum stays on-host before it crosses hosts.
    Ranks that share a ``data`` index repeat the same work.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if data_axis is None:
        if world % lattice_axis:
            raise ValueError(f"{world} ranks do not split into lattice axis "
                             f"{lattice_axis}")
        data_axis = world // lattice_axis
    return make_mesh((data_axis, lattice_axis), ("data", "lattice"))


def process_local_batch_slice(global_batch: int, mesh: Mesh | None = None,
                              data_axis: str = "data") -> slice:
    """The [start, stop) range of the global batch this rank loads.

    With B samples over the D entries of the mesh's ``data`` axis, the
    rank at data index d loads [d*B/D, (d+1)*B/D).  Without a mesh, D is
    the world size and d the rank (the global mesh's layout), as JAX's
    per-process rule gives.
    """
    if mesh is None:
        initialized = dist.is_initialized()
        n = dist.get_world_size() if initialized else 1
        d = dist.get_rank() if initialized else 0
    else:
        n, d = mesh.shape[data_axis], mesh.coordinate()[data_axis]
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} data-parallel ranks")
    per = global_batch // n
    return slice(d * per, (d + 1) * per)
