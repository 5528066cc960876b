"""Data-parallel training: the global batch split over the ``data`` axis.

Port of ``hplflownet_tpu/parallel/data_parallel.py``.  Parameters and Adam
state are replicated (rank 0's are broadcast when the state is made); each
rank runs the train step's forward on its slice of the global batch.  The
loss is JAX's global loss: the sum of per-point errors over the valid
points of every rank, over the global valid count.  So each rank
all-reduces its valid count first, takes the gradient of its own sum over
that global count, and the gradients are summed across ranks.  (Averaging
per-rank losses, as ``DistributedDataParallel`` does, is wrong whenever
ranks hold different numbers of valid points; padded batches make that
the usual case.)

The sum runs once per step, on one flat float32 buffer of every gradient
in parameter order, the rank's error sum and its overflow count; the
collective's result is the same on every rank, so Adam (``train.step``'s)
keeps the replicas identical.  No float atomics; TF32 is off.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..lattice.build import LatticeSpec
from ..train.step import (TrainState, _batch_to, _batched_pred, _param_device,
                          adam_update, create_train_state)
from .mesh import Mesh

__all__ = ["shard_batch", "loss_and_grad", "make_dp_train_step"]


def shard_batch(batch: Mapping, mesh: Mesh, data_axis: str = "data",
                device=None) -> dict:
    """This rank's part of the batch as tensors on ``device`` (the CUDA
    card by default).

    Each rank passes only its own slice of the global batch
    (``process_local_batch_slice``), as the JAX package's multi-process
    path does; a single process passes the whole batch.  ``path`` and
    ``num_real`` pass through.
    """
    if data_axis not in mesh.shape:
        raise KeyError(f"no axis {data_axis!r} on the mesh {mesh.shape}")
    out = _batch_to(batch, resolve_device(device))
    for k in ("path", "num_real"):
        if k in batch:
            out[k] = batch[k]
    return out


def loss_and_grad(model, spec: LatticeSpec, params: Mapping, batch: Mapping,
                  mesh: Mesh, data_axis: str = "data"):
    """-> (global loss, global overflow, {name: summed gradient}) at
    ``params`` on this rank's ``batch``; every rank of the ``data`` group
    gets the same values."""
    group = mesh.group(data_axis)
    batch = _batch_to(batch, _param_device(model))
    w = batch["valid1"].to(torch.float32)
    count = torch.sum(w)                 # exact in float32 below 2^24 points
    if group is not None:
        dist.all_reduce(count, group=group)
    denom = torch.clamp_min(count, 1.0)
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    pred, overflow = _batched_pred(model, spec, leaves, batch)
    err = torch.linalg.vector_norm(pred - batch["sf"], dim=-1)
    numer = torch.sum(err * w)
    grads = torch.autograd.grad(numer / denom, list(leaves.values()),
                                materialize_grads=True)
    flat = torch.cat([g.reshape(-1) for g in grads]
                     + [numer.detach().reshape(1),
                        overflow.to(torch.float32).reshape(1)])
    if group is not None:
        dist.all_reduce(flat, group=group)
    out, at = {}, 0
    for k, g in zip(leaves, grads):
        out[k] = flat[at:at + g.numel()].view_as(g)
        at += g.numel()
    return flat[at] / denom, flat[at + 1].to(torch.int32), out


def make_dp_train_step(model, spec: LatticeSpec, mesh: Mesh,
                       learning_rate: float = 1e-4, data_axis: str = "data",
                       device=None):
    """-> (init_state, train_step), as the JAX package's.

    ``init_state(params=None)`` makes the replicated state (the model's
    parameters by default) and broadcasts rank 0's.
    ``train_step(state, batch) -> (state, loss)`` with the global loss;
    ``train_step.with_overflow`` also returns the global overflow count and
    ``train_step.with_grads`` that and the summed gradients.  ``batch`` is
    this rank's slice of the global batch.  Ranks that share a ``data``
    index (a ``lattice`` axis above 1) repeat the same work.
    """
    dev = resolve_device(device)
    if _param_device(model) != dev:
        raise ValueError(f"the model's parameters are on {_param_device(model)}, "
                         f"not on {dev}")
    # the gradient sum must not depend on TF32 products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def init_state(params=None) -> TrainState:
        state = create_train_state(model if params is None else params,
                                   learning_rate, device=dev)
        if dist.is_initialized() and dist.get_world_size() > 1:
            flat = torch.cat([v.reshape(-1) for v in state.params.values()])
            dist.broadcast(flat, src=0)
            at = 0
            for v in state.params.values():
                v.copy_(flat[at:at + v.numel()].view_as(v))
                at += v.numel()
        return state

    def with_grads(state: TrainState, batch):
        loss, overflow, grads = loss_and_grad(model, spec, state.params, batch,
                                              mesh, data_axis)
        params, opt = adam_update(grads, state.opt_state, state.params)
        return (TrainState(params=params, opt_state=opt, step=state.step + 1),
                loss, overflow, grads)

    def with_overflow(state: TrainState, batch):
        return with_grads(state, batch)[:3]

    def train_step(state: TrainState, batch):
        return with_grads(state, batch)[:2]

    train_step.with_overflow = with_overflow
    train_step.with_grads = with_grads
    return init_state, train_step
