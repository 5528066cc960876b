"""``rank_partial``: per-128-entry-block partial sums by local run rank.

    out[b*128 + k, :C] = sum_{j in block b, lrank_j = k} round_dtype(w_j * g[j, :C])
    out[b*128 + k, C]  = sum_{j in block b, lrank_j = k} w_j   (if with_weights)
    lrank_j = meta[j] & 0xFFFF,  w_j = g[j, C + (meta[j] >> 16)]

or, with R = 0, the rows summed unweighted.  The output has ceil(M/128)*128
rows, in float32 or bfloat16; rows of unused ranks are exact zeros.  This
is the function of ``hplflownet_tpu/ops/pallas_stencil.py``
``blocked_rank_partial`` (:735), the partial stage the port's
``rank_reduce`` fuses away; the TPU rank-partial lab timed variants of it.

Replaces ``tools/rank_partial_lab.py`` ``variant`` (:110; ``pallas_call``
:121, body ``_v2_kernel`` :74).  ``bo``, the lab's blocks-per-program sweep,
is the number of 128-entry blocks each CUDA block takes; the launch splits
each block's 128 ranks over up to 16 CUDA blocks so that the grid has two
per SM, and the next block loads while one is summed and stored.  The
variant's ``vec_prepass`` has no counterpart: the
products are formed as they are summed.  On CUDA tensors the wrapper launches
``csrc/rank_partial.cu``; on CPU tensors it runs :func:`rank_partial_plain`.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry
from .splat import segment_sums64, stream_products

__all__ = ["rank_partial", "rank_partial_plain", "BLOCK"]

BLOCK = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rank_partial_plain(g, meta, c, r, with_weights=False,
                       out_dtype=torch.float32):
    """Plain PyTorch version: a float64 segmented sum per block, keyed by
    block * 128 + local rank (:func:`.splat.segment_sums64`)."""
    m = g.shape[0]
    meta = meta.long()
    lrank = meta & 0xFFFF
    lane = (meta >> 16).to(torch.int32) if r else None
    sv = stream_products(g, lane, c, with_weights)
    pos = torch.arange(m, device=g.device)
    key = torch.where(lrank < BLOCK, pos - pos % BLOCK + lrank, -1)
    m_pad = -(-m // BLOCK) * BLOCK
    return segment_sums64(sv, key, m_pad).to(torch.float32).to(out_dtype)


def _check_args(g, meta, c, r, with_weights, bo, out_dtype):
    if g.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"stream and output must be float32 or bfloat16, got "
                        f"{g.dtype} and {out_dtype}")
    if g.dim() != 2 or c <= 0 or r < 0 or g.shape[1] != c + r:
        raise ValueError(f"expected g (M, C + R), got {tuple(g.shape)}, "
                         f"C = {c}, R = {r}")
    if r == 0 and with_weights:
        raise ValueError("the plain-row mode (R = 0) has no density")
    if bo < 1:
        raise ValueError(f"bo must be >= 1, got {bo}")
    if meta.dtype != torch.int32 or meta.shape != (g.shape[0],):
        raise TypeError("meta must be an (M,) int32 tensor")
    for t in (g, meta):
        if t.device != g.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def rank_partial(g: torch.Tensor,      # (M, C + R) sorted stream
                 meta: torch.Tensor,   # (M,) int32: lrank | lane << 16
                 c: int, r: int,
                 with_weights: bool = False,
                 bo: int = 8,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Block partial sums -> (ceil(M/128)*128, C [+ 1]) in ``out_dtype``."""
    if g.device.type == "cpu" or plain_forced():
        return rank_partial_plain(g, meta, c, r, with_weights, out_dtype)
    if g.device.type != "cuda":
        raise ValueError(f"no kernel for device {g.device}")
    _check_args(g, meta, c, r, with_weights, bo, out_dtype)
    m, cr = g.shape
    out = torch.empty((-(-m // BLOCK) * BLOCK, c + int(with_weights)),
                      dtype=out_dtype, device=g.device)
    fn = entry("rank_partial", "hpl_rank_partial", "piiipiipiip")
    stream = torch.cuda.current_stream(g.device).cuda_stream
    rc = fn(g.data_ptr(), m, cr, c, meta.data_ptr(), bo, int(with_weights),
            out.data_ptr(), _DTYPES[g.dtype], _DTYPES[out_dtype], stream)
    check("rank_partial", rc, "rank_partial launch")
    rank_partial.launches += 1
    return out


rank_partial.launches = 0
