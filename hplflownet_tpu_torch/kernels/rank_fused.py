"""``blocked_rank_reduce``: the fused rank-mode reduction of a sorted stream.

    out[t, :C] = sum_{j : rank_j = t} round_dtype(w_j * g[j, :C])
    out[t, C]  = sum_{j : rank_j = t} w_j          (density, if with_weights)
    rank_j = meta[j] >> 2,  w_j = g[j, C + (meta[j] & 3)]      (1 <= R <= 4)

or, with R = 0, ``rank_j = meta[j]`` and the rows summed unweighted.  Block
b of 128 ranks sums the entries of the stream range ``[start_rows[b],
start_rows[b + 1])`` (the last block up to M); in a rank-mode plan that
range holds every entry of the block's ranks.  The output has
``len(start_rows) * 128`` rows; ranks with no entry are exact zeros.

Replaces ``hplflownet_tpu/ops/pallas_stencil.py`` ``blocked_rank_reduce``
(:648; ``pallas_call`` :724, body ``_rank_reduce_kernel`` :580) without its
TPU windows: every entry of a block's range is read, so nothing is dropped
and there is no overflow counter.  On CUDA tensors the wrapper launches
``csrc/blocked_rank_reduce.cu`` (tiles of 32 ranks, slabs of at most 128
columns, the stream staged through shared memory at most ``STAGE_ROWS``
rows at a time, a rank's partial sums carried across stages); on CPU
tensors it runs :func:`blocked_rank_reduce_plain`.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry
from .splat import segment_sums64, stream_products

__all__ = ["blocked_rank_reduce", "blocked_rank_reduce_plain", "RANKS",
           "STAGE_ROWS"]

RANKS = 128                      # ranks per block of the output
STAGE_ROWS = 128                 # most stream rows a shared-memory stage holds
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _ranks_and_lanes(meta, r):
    meta = meta.long()
    if r:
        return meta >> 2, (meta & 3).to(torch.int32)
    return meta, None


def blocked_rank_reduce_plain(g, meta, start_rows, c, r, with_weights=False):
    """Plain PyTorch version: float64 sums by rank of the entries that lie in
    their rank block's stream range, as a stable sort + prefix differences
    (:func:`.splat.segment_sums64`)."""
    m = g.shape[0]
    nblk = start_rows.shape[0]
    rank, lane = _ranks_and_lanes(meta, r)
    sv = stream_products(g, lane, c, with_weights)
    lo = start_rows.long().clamp(0, m)
    hi = torch.cat([start_rows[1:].long(), lo.new_full((1,), m)])
    hi = torch.maximum(hi.clamp(0, m), lo)
    blk = torch.div(rank, RANKS, rounding_mode="floor")
    ok = (rank >= 0) & (blk < nblk)
    safe = blk.clamp(0, max(nblk - 1, 0))
    pos = torch.arange(m, device=g.device)
    ok = ok & (pos >= lo[safe]) & (pos < hi[safe]) if nblk else ok
    key = torch.where(ok, rank, -1)
    return segment_sums64(sv, key, nblk * RANKS).to(torch.float32)


def _check_args(g, meta, start_rows, c, r, with_weights):
    if g.dtype not in _DTYPES:
        raise TypeError(f"stream must be float32 or bfloat16, got {g.dtype}")
    if g.dim() != 2 or c <= 0 or g.shape[1] != c + r or not 0 <= r <= 4:
        raise ValueError(f"expected g (M, C + R) with 0 <= R <= 4, got "
                         f"{tuple(g.shape)}, C = {c}, R = {r}")
    if r == 0 and with_weights:
        raise ValueError("the plain-row mode (R = 0) has no density")
    for name, t, n in (("meta", meta, g.shape[0]),
                       ("start_rows", start_rows, None)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    for t in (g, meta, start_rows):
        if t.device != g.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def blocked_rank_reduce(g: torch.Tensor,           # (M, C + R) sorted stream
                        meta: torch.Tensor,        # (M,) int32
                        start_rows: torch.Tensor,  # (ceil(T/128),) int32
                        c: int, r: int,
                        with_weights: bool = False) -> torch.Tensor:
    """Per-rank sums -> (len(start_rows) * 128, C [+ 1]) float32.

    ``meta`` is ``rank << 2 | lane`` with R >= 1 weight lanes, or the rank
    with R = 0.  Ranks must not decrease along the stream inside a block's
    range for the kernel to read each entry once; any other order gives the
    same sums, read more often.
    """
    if g.device.type == "cpu" or plain_forced():
        return blocked_rank_reduce_plain(g, meta, start_rows, c, r, with_weights)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    _check_args(g, meta, start_rows, c, r, with_weights)
    m, cr = g.shape
    nblk = start_rows.shape[0]
    out = torch.empty((nblk * RANKS, c + int(with_weights)),
                      dtype=torch.float32, device=g.device)
    fn = entry("blocked_rank_reduce", "hpl_blocked_rank_reduce", "piiippiipip")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(g.data_ptr(), m, cr, c, meta.data_ptr(), start_rows.data_ptr(),
            nblk, int(with_weights), out.data_ptr(), _DTYPES[g.dtype], stream)
    check("blocked_rank_reduce", rc, "blocked_rank_reduce launch")
    blocked_rank_reduce.launches += 1
    return out


blocked_rank_reduce.launches = 0
