"""Deterministic segment reductions for lattice splatting.

Port of ``hplflownet_tpu/ops/segment.py``: the plans, ``apply_reduce_plan``
and ``weighted_reduce`` with their adjoints.  A :class:`ReducePlan` sorts a
flat (M,) array of target ids once and records each target's contiguous run
``[start, end)`` in sorted order; a reduction then sums each run.  The
lattice build's splat plans are rank-mode plans (their target ids are the
dense vertex ranks).

Two routes reduce a rank-mode plan's weighted stream: by default the
``rank_reduce`` kernel sums each ``[start, end)`` run; with
``HPL_RANK_FUSED=1`` (``ops.dispatch.rank_fused_enabled``, off in
``exact_mode()``) the ``blocked_rank_reduce`` kernel sums by the rank each
entry carries, as JAX's ``_wr_rank_fused`` does.  Both sum a run in stream
order, so on the card they agree bit for bit on every plan whose runs
average fewer than ``SPLIT`` entries: every plan of the two flow models, at
every capacity the benchmark gives them (tests/test_torch_splatnet.py pins
it).  Longer runs the default route sums in parts (:func:`run_sums`), which
rounds otherwise than one walk of the run.

Invalid entries (id -1: invalid points, or vertices dropped past capacity)
lie in no run and contribute nothing; on the fused route they carry a rank
that matches no output row.  The rank-mode contract of the JAX package —
invalid entries carry exact zeros — is never needed: the port's builder
does not zero the points of vertices dropped past capacity.

No float atomics anywhere (no ``index_add_`` / ``scatter_add_``): every run
is summed in a fixed order, so a rerun matches bit for bit.  The adjoint of
a reduction is a row gather of the cotangent (the reference's
SparseSum.backward rule), so the backward needs no scatter either.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels import backward_like_forward, plain_forced
from ..kernels.rank_fused import blocked_rank_reduce
from ..kernels.splat import rank_reduce
from .dispatch import rank_fused_enabled

__all__ = ["ReducePlan", "local_ranks", "make_reduce_plan",
           "apply_reduce_plan", "weighted_reduce", "rank_fused_args",
           "run_sums", "SPLIT"]

_BLOCK = 128
SPLIT = 32                       # entries per part of a long run (run_sums)
_BIG = int(np.iinfo(np.int32).max)
_NO_RANK = 1 << 28               # the fused route's rank for id -1 entries


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


def _rows_gather(plan: ReducePlan, g: torch.Tensor) -> torch.Tensor:
    """The adjoint of a reduction: entry j receives row ``ids[j]`` of the
    (T, C) cotangent, id -1 a zero row."""
    ids = plan.ids
    rows = g[ids.clamp(0, g.shape[0] - 1).long()]
    return torch.where((ids >= 0)[:, None], rows, 0)


class _ApplyReducePlan(torch.autograd.Function):
    """``apply_reduce_plan`` of the JAX package (segment.py:132-141, adjoint
    :321-328): forward through ``rank_reduce``'s plain-row mode, backward a
    row gather."""

    @staticmethod
    def forward(ctx, plan, vals):
        ctx.plain_kernels = plain_forced()
        ctx.plan = plan
        g = vals[plan.perm.long()].contiguous()                 # (M, C)
        out = rank_reduce(g, None, plan.start, plan.end, vals.shape[1])
        return out.to(vals.dtype)

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):
        return None, _rows_gather(ctx.plan, g)


def apply_reduce_plan(plan: ReducePlan, vals: torch.Tensor) -> torch.Tensor:
    """(M, C) source values -> (T, C) per-target sums, in ``vals.dtype``.

    The values are gathered into the plan's sorted order and each run is
    summed in float32 by the ``rank_reduce`` kernel's plain-row mode, then
    cast back, as JAX's float32 reduction is.  Differentiable in ``vals``.
    """
    return _ApplyReducePlan.apply(plan, vals)


def rank_fused_args(plan: ReducePlan, rid: torch.Tensor | None):
    """``(meta, start_rows)`` of the fused route for a rank-mode plan's
    sorted stream (JAX ``segment._wr_rank_fused``, :357-387).

    Each sorted entry carries its global rank, ``ids[perm]`` (JAX derives
    the same value on valid entries as ``r0[j // 128] + lrank[j]``); an id
    -1 entry gets a rank past every output row.  ``meta`` is ``rank << 2 |
    rid``, or the rank when ``rid`` is None (plain rows).  Block b of 128
    ranks reads the stream from the start of its first rank's run,
    ``start_rows[b] = start[128 b]`` (the stream's end past the last rank).
    """
    m = plan.perm.shape[0]
    t = plan.start.shape[0]
    rank = plan.ids[plan.perm.long()]
    rank = torch.where(rank >= 0, rank, _NO_RANK)
    meta = rank if rid is None else (rank << 2) | rid
    tp = -(-t // _BLOCK) * _BLOCK
    start = plan.start
    if tp != t:
        start = torch.cat([start, start.new_full((tp - t,), m)])
    return meta.contiguous(), start[::_BLOCK].contiguous()


def _wr_rank_fused(plan: ReducePlan, g: torch.Tensor, rid: torch.Tensor,
                   c: int, r: int, with_weights: bool) -> torch.Tensor:
    """The fused route: ``blocked_rank_reduce`` over the plan's ranks."""
    meta, start_rows = rank_fused_args(plan, rid)
    out = blocked_rank_reduce(g, meta, start_rows, c, r, with_weights)
    return out[:plan.start.shape[0]]


def run_sums(g: torch.Tensor, rid: torch.Tensor | None, start: torch.Tensor,
             end: torch.Tensor, c: int, with_weights: bool) -> torch.Tensor:
    """``rank_reduce``'s run sums, where the runs average ``SPLIT`` entries
    or more (a lattice with far fewer vertices than splat entries: a coarse
    scale built from a whole cloud) in two launches: each run in parts of
    at most ``SPLIT`` entries, then each run's parts in order.

    The kernel walks a run with one warp, so one launch over such a plan
    takes as long as its longest run (thousands of entries at SPLATNet3D's
    coarsest scale), and that length is the cloud's.  Parts fill the card
    whatever the runs' lengths.  The sums are folds in a fixed order: a
    rerun gives the same bits.  Shapes stay static: the parts are bounded
    by T + ceil(M / SPLIT), and the bound's unused parts are empty runs.

    A stopgap: once ``rank_reduce`` splits a long run over warps itself,
    this function and ``SPLIT`` go, and ``_wr_forward`` calls the kernel
    once again.
    """
    m, t = g.shape[0], start.shape[0]
    if m < SPLIT * t:
        return rank_reduce(g, rid, start, end, c, with_weights)
    n = torch.div(end - start + (SPLIT - 1), SPLIT, rounding_mode="floor")
    last = torch.cumsum(n, dim=0, dtype=torch.int32)          # parts to run t
    first = last - n
    j = torch.arange(t - (-m // SPLIT), dtype=torch.int32, device=g.device)
    run = torch.searchsorted(last, j, right=True, out_int32=True).clamp(max=t - 1)
    live = j < last[-1]
    lo = start[run] + (j - first[run]) * SPLIT
    hi = torch.minimum(lo + SPLIT, end[run])
    parts = rank_reduce(g, rid, torch.where(live, lo, m),
                        torch.where(live, hi, m), c, with_weights)
    return rank_reduce(parts, None, first, last, parts.shape[1])


def _wr_forward(with_weights: bool, plan: ReducePlan, rows: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
    r = weights.shape[1]
    c = rows.shape[1]
    perm = plan.perm.long()
    cat = torch.cat([rows, weights.to(rows.dtype)], dim=1)     # (N, C+R)
    g = cat[perm // r]                                          # (M, C+R)
    rid = (perm % r).to(torch.int32)
    if plan.r0.shape[0] > 1 and rank_fused_enabled():
        return _wr_rank_fused(plan, g, rid, c, r, with_weights)
    return run_sums(g, rid, plan.start, plan.end, c, with_weights)


class _WeightedReduce(torch.autograd.Function):
    """Forward through ``rank_reduce``; backward ``_wr_bwd`` of the JAX
    package (segment.py:432-449): R row gathers of the float32 cotangent."""

    @staticmethod
    def forward(ctx, with_weights, plan, rows, weights):
        ctx.plain_kernels = plain_forced()
        ctx.with_weights = with_weights
        ctx.plan = plan
        ctx.save_for_backward(rows, weights)
        return _wr_forward(with_weights, plan, rows, weights)

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):
        rows, weights = ctx.saved_tensors
        n, c = rows.shape
        r = weights.shape[1]
        t = ctx.plan.start.shape[0]
        ids = ctx.plan.ids.reshape(n, r)
        want_rows, want_w = ctx.needs_input_grad[2], ctx.needs_input_grad[3]
        gf = g.to(torch.float32)
        d_rows = rows.new_zeros((n, c), dtype=torch.float32) if want_rows else None
        d_w = []
        for k in range(r):
            present = (ids[:, k] >= 0)[:, None]
            grow = torch.where(present, gf[ids[:, k].clamp(0, t - 1).long()], 0.0)
            if want_rows:
                d_rows = d_rows + weights[:, k, None] * grow[:, :c]
            if want_w:
                dwk = torch.sum(rows.to(torch.float32) * grow[:, :c], dim=1)
                d_w.append(dwk + grow[:, c] if ctx.with_weights else dwk)
        return (None, None, d_rows.to(rows.dtype) if want_rows else None,
                torch.stack(d_w, dim=1) if want_w else None)


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
    kernel (csrc/rank_reduce.cu) on CUDA tensors, or on the fused route
    through ``blocked_rank_reduce`` (csrc/blocked_rank_reduce.cu).
    Differentiable in ``rows`` and ``weights``; the gradient of ``rows`` is
    cast to its dtype.
    """
    return _WeightedReduce.apply(with_weights, plan, rows, weights)
