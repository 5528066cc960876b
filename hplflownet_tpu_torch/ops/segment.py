"""Deterministic segment reductions for lattice splatting (forward).

Port of the forward half of ``hplflownet_tpu/ops/segment.py``.  A
:class:`ReducePlan` sorts a flat (M,) array of target ids once and records
each target's contiguous run ``[start, end)`` in sorted order; a reduction
then sums each run.  The lattice build's splat plans are rank-mode plans
(their target ids are the dense vertex ranks).

Invalid entries (id -1: invalid points, or vertices dropped past capacity)
lie in no run and contribute nothing.  The rank-mode contract of the JAX
package still holds — invalid entries carry exact zeros — but this port
never needs it: its runs exclude them.

No float atomics anywhere (no ``index_add_`` / ``scatter_add_``): every run
is summed in a fixed order, so a rerun matches bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.splat import rank_reduce

__all__ = ["ReducePlan", "local_ranks", "make_reduce_plan", "weighted_reduce"]

_BLOCK = 128
_BIG = int(np.iinfo(np.int32).max)


class ReducePlan(NamedTuple):
    """Static-shape plan to segment-sum M source entries into T targets."""

    ids: torch.Tensor    # (M,) i32 target id per source entry; -1 drops
    perm: torch.Tensor   # (M,) i32 sorted position -> source index
    start: torch.Tensor  # (T,) i32 run starts in sorted order
    end: torch.Tensor    # (T,) i32 run ends
    lrank: torch.Tensor  # (M,) i32 run rank local to each 128-entry block
    r0: torch.Tensor     # (ceil(M/128),) i32 block-first global rank
                         # (rank-mode plans), size-1 dummy otherwise


def local_ranks(same_as_prev: torch.Tensor) -> torch.Tensor:
    """Per-entry run rank local to each 128-entry block of a sorted stream.

    A new run starts on every key change and at every block boundary.
    """
    m = same_as_prev.shape[0]
    pad = (-m) % _BLOCK
    sp = same_as_prev
    if pad:
        sp = torch.cat([sp, torch.zeros(pad, dtype=torch.bool, device=sp.device)])
    pos = torch.arange(sp.shape[0], device=sp.device)
    new = (~sp) | (pos % _BLOCK == 0)
    blocked = new.to(torch.int32).reshape(-1, _BLOCK)
    lrank = torch.cumsum(blocked, dim=1, dtype=torch.int32).reshape(-1) - 1
    return lrank[:m]


def make_reduce_plan(ids: torch.Tensor, num_targets: int) -> ReducePlan:
    """Sort/run structure for a flat (M,) id array (a generic plan)."""
    flat = ids.reshape(-1).to(torch.int32)
    key = torch.where(flat < 0, _BIG, flat)
    sorted_ids, perm = torch.sort(key, stable=True)
    targets = torch.arange(num_targets, dtype=torch.int32, device=flat.device)
    start = torch.searchsorted(sorted_ids, targets, side="left", out_int32=True)
    end = torch.searchsorted(sorted_ids, targets, side="right", out_int32=True)
    same = torch.cat([torch.zeros(1, dtype=torch.bool, device=flat.device),
                      sorted_ids[1:] == sorted_ids[:-1]])
    return ReducePlan(ids=flat, perm=perm.to(torch.int32), start=start,
                      end=end, lrank=local_ranks(same),
                      r0=torch.zeros(1, dtype=torch.int32, device=flat.device))


def weighted_reduce(with_weights: bool, plan: ReducePlan,
                    rows: torch.Tensor,      # (N, C)
                    weights: torch.Tensor    # (N, R) f32
                    ) -> torch.Tensor:
    """Per-target sums of ``weights[n, r] * rows[n]``: the splat pattern.

    Returns (T, C) float32, or (T, C + 1) with the weight sums (densities)
    as the last column when ``with_weights``.  The (M, C + R) stream is
    gathered once in sorted order, in ``rows.dtype``: a bf16 stream rounds
    the weights to bf16 and each product to bf16 before the float32 sum,
    as the JAX package does.  The run sums go through the ``rank_reduce``
    kernel (csrc/rank_reduce.cu) on CUDA tensors.
    """
    r = weights.shape[1]
    c = rows.shape[1]
    perm = plan.perm.long()
    cat = torch.cat([rows, weights.to(rows.dtype)], dim=1)     # (N, C+R)
    g = cat[perm // r]                                          # (M, C+R)
    rid = (perm % r).to(torch.int32)
    return rank_reduce(g, rid, plan.start, plan.end, c, with_weights)
