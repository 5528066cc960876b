"""``rank_reduce``: the splat reduction over a sorted splat stream.

    out[t, :C] = sum_{j in run t} round_dtype(g[j, :C] * w_j)
    out[t, C]  = sum_{j in run t} w_j             (density, if with_weights)
    w_j        = g[j, C + rid[j]]

or, with R = 0 (``rid`` None, g (M, C): plain rows, no density),

    out[t, :C] = sum_{j in run t} g[j, :C]

Replaces ``hplflownet_tpu/ops/pallas_stencil.py`` ``blocked_rank_partial``
(:735; ``pallas_call`` :763, body ``_rank_partial_kernel`` :547) together
with ``segment._combine`` (:247-314): only the per-vertex sums are
observable, so the partial and combine stages fuse into one deterministic
segmented sum.  On CUDA tensors the wrapper launches
``csrc/rank_reduce.cu`` (a lane group per vertex, wide row loads, batches
of entries loaded ahead of their in-order sums; :func:`rank_reduce_regime`
gives the launch's choice); on CPU tensors it runs
:func:`rank_reduce_plain`.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry

__all__ = ["rank_reduce", "rank_reduce_plain", "rank_reduce_regime",
           "stream_products", "segment_sums64"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stream_products(g, rid, c, with_weights):
    """(M, C[+1]) stream-dtype products and weights; ``rid`` None (R = 0)
    gives the plain rows.  A lane index outside [0, R) selects weight 0."""
    if rid is None:
        if with_weights:
            raise ValueError("the plain-row mode (R = 0) has no density")
        return g[:, :c]
    r = g.shape[1] - c
    rid = rid.long()[:, None]
    ok = (rid >= 0) & (rid < r)
    w = torch.gather(g[:, c:], 1, rid.clamp(0, r - 1))        # exact select
    w = torch.where(ok, w, 0)
    sv = g[:, :c] * w                                           # rounded
    if with_weights:
        sv = torch.cat([sv, w], dim=1)
    return sv


def segment_sums64(sv: torch.Tensor, key: torch.Tensor, n_out: int
                   ) -> torch.Tensor:
    """Float64 sums of the rows of ``sv`` by ``key``, for keys in
    [0, n_out) -> (n_out, C) float64; rows with other keys are dropped.

    A stable sort by key, then float64 prefix differences: exact to far
    below float32 resolution, deterministic, and free of atomics.
    """
    key = key.long()
    order = torch.argsort(key, stable=True)
    ks = key[order]
    sv = sv.to(torch.float64)[order]
    csum = torch.cat([sv.new_zeros(1, sv.shape[1]), torch.cumsum(sv, dim=0)])
    q = torch.arange(n_out, device=key.device)
    s = torch.searchsorted(ks, q, side="left")
    e = torch.searchsorted(ks, q, side="right")
    return csum[e] - csum[s]


def rank_reduce_plain(g, rid, start, end, c, with_weights=False):
    """Plain PyTorch version: run sums as float64 prefix differences.

    The float64 prefix keeps each run's sum exact to far below float32
    resolution, so this version is a deterministic reference, not a copy of
    the kernel's summation order.
    """
    sv = stream_products(g, rid, c, with_weights).to(torch.float64)
    csum = torch.cat([sv.new_zeros(1, sv.shape[1]), torch.cumsum(sv, dim=0)])
    s = start.long().clamp(0, g.shape[0])
    e = torch.maximum(end.long().clamp(0, g.shape[0]), s)
    return (csum[e] - csum[s]).to(torch.float32)


def _check_args(g, rid, start, end, c, with_weights=False):
    if g.dtype not in _DTYPES:
        raise TypeError(f"stream must be float32 or bfloat16, got {g.dtype}")
    if rid is None:
        if g.dim() != 2 or c != g.shape[1] or c <= 0 or with_weights:
            raise ValueError(f"the plain-row mode (no rid) takes g (M, C) "
                             f"and no density, got {tuple(g.shape)}, C = {c}")
    elif g.dim() != 2 or not 0 <= c < g.shape[1]:
        raise ValueError(f"expected g (M, C + R) with R >= 1, got "
                         f"{tuple(g.shape)} and C = {c}")
    for name, t, n in (("rid", rid, g.shape[0]), ("start", start, None),
                       ("end", end, start.shape[0])):
        if t is None:
            continue
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor")
        if n is not None and t.shape[0] != n:
            raise ValueError(f"{name} has {t.shape[0]} entries, expected {n}")
    for t in (g, start, end) + ((rid,) if rid is not None else ()):
        if t.device != g.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def rank_reduce(g: torch.Tensor,       # (M, C + R) sorted stream
                rid: torch.Tensor | None,  # (M,) int32 weight lane per entry
                start: torch.Tensor,   # (T,) int32 run starts
                end: torch.Tensor,     # (T,) int32 run ends
                c: int,
                with_weights: bool = False) -> torch.Tensor:
    """Per-target weighted run sums -> (T, C) or (T, C + 1) float32.

    ``rid`` None selects the plain-row mode (R = 0): g is (M, C) and each
    run's rows are summed unweighted, with no density column.
    """
    if g.device.type == "cpu" or plain_forced():
        return rank_reduce_plain(g, rid, start, end, c, with_weights)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    _check_args(g, rid, start, end, c, with_weights)
    m, cr = g.shape
    t = start.shape[0]
    out = torch.empty((t, c + int(with_weights)), dtype=torch.float32,
                      device=g.device)
    fn = entry("rank_reduce", "hpl_rank_reduce", "piiipppiipip")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(g.data_ptr(), m, cr, c, None if rid is None else rid.data_ptr(),
            start.data_ptr(), end.data_ptr(), t, int(with_weights),
            out.data_ptr(), _DTYPES[g.dtype], stream)
    check("rank_reduce", rc, "rank_reduce launch")
    rank_reduce.launches += 1
    return out


rank_reduce.launches = 0


def rank_reduce_regime(g: torch.Tensor, rid: torch.Tensor | None,
                       start: torch.Tensor, c: int,
                       with_weights: bool = False) -> dict | None:
    """The kernel's choice for a CUDA stream ``g`` and ``start.shape[0]``
    runs (a warp per vertex and column slice): bytes per row load
    (``vec_bytes``), chunks per lane, column slices (``passes``) and
    entries per batch (``batch``: 1, 4 or 16 by the runs' mean length,
    capped by registers); None for a CPU tensor, which runs the plain
    version."""
    if g.device.type != "cuda":
        return None
    fn = entry("rank_reduce", "hpl_rank_reduce_regime", "piiiiii")
    code = fn(g.data_ptr(), g.shape[0], g.shape[1], c, start.shape[0],
              int(with_weights), _DTYPES[g.dtype])
    if code < 0 or (rid is None) != (g.shape[1] == c):
        raise ValueError(f"rank_reduce takes no stream {tuple(g.shape)} with "
                         f"C = {c}")
    return dict(vec_bytes=code & 0xFF, chunks=code >> 8 & 0xFF,
                passes=code >> 16 & 0xFF, batch=code >> 24)
