"""``stencil_tap_tables_sum``: the gather-only stencil over per-tap tables.

    out[v] = sum_f tables[nb[f, v], f*C:(f+1)*C]            -> (H_out, C) f32

Replaces ``hplflownet_tpu/ops/pallas_stencil.py`` ``stencil_tap_tables_sum``
(:461; ``pallas_call`` :531, body ``_tts_kernel`` :421).  On CUDA tensors
the wrapper launches ``csrc/stencil_tap_tables_sum.cu`` (a lane group per
output vertex lists its present taps once and loads their rows a batch at
a time); on CPU tensors it runs :func:`stencil_tap_tables_sum_plain`.
Unlike the TPU kernel it takes any C (no 128-lane padding) and writes no
per-group partial planes.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry

__all__ = ["stencil_tap_tables_sum", "stencil_tap_tables_sum_plain"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def stencil_tap_tables_sum_plain(tables, c, neighbors):
    """Plain PyTorch version: one masked row gather per tap, summed in tap
    order in float32 (the kernel's order)."""
    f, h_out = neighbors.shape
    out = torch.zeros((h_out, c), dtype=torch.float32, device=tables.device)
    for k in range(f):
        ids = neighbors[k].long()
        rows = tables[ids.clamp(min=0), k * c:(k + 1) * c].to(torch.float32)
        out = out + torch.where((ids >= 0)[:, None], rows, 0.0)
    return out


def _check_args(tables, c, neighbors):
    if tables.dtype not in _DTYPES:
        raise TypeError(f"tables must be float32 or bfloat16, got {tables.dtype}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be int32, got {neighbors.dtype}")
    if tables.dim() != 2 or neighbors.dim() != 2:
        raise ValueError("expected tables (H, F * C) and neighbors (F, H_out)")
    if c <= 0 or tables.shape[1] != neighbors.shape[0] * c:
        raise ValueError(f"tables {tuple(tables.shape)} is not (H, F * C) for "
                         f"F = {neighbors.shape[0]}, C = {c}")
    for t in (tables, neighbors):
        if t.device != tables.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def stencil_tap_tables_sum(tables: torch.Tensor,     # (H, F * C) tap-major
                           c: int,                   # per-tap width C
                           neighbors: torch.Tensor   # (F, H_out) int32, -1 absent
                           ) -> torch.Tensor:
    """out[v] = sum_f tables[neighbors[f, v], f*C:(f+1)*C] -> (H_out, C) f32."""
    if tables.device.type == "cpu" or plain_forced():
        return stencil_tap_tables_sum_plain(tables, c, neighbors)
    if tables.device.type != "cuda":
        raise ValueError(f"no kernel for device {tables.device}")
    _check_args(tables, c, neighbors)
    f, h_out = neighbors.shape
    out = torch.empty((h_out, c), dtype=torch.float32, device=tables.device)
    fn = entry("stencil_tap_tables_sum", "hpl_stencil_tap_tables_sum", "piipiipip")
    stream = torch.cuda.current_stream(tables.device).cuda_stream
    rc = fn(tables.data_ptr(), tables.shape[0], c, neighbors.data_ptr(), f,
            h_out, out.data_ptr(), _DTYPES[tables.dtype], stream)
    check("stencil_tap_tables_sum", rc, "stencil_tap_tables_sum launch")
    stencil_tap_tables_sum.launches += 1
    return out


stencil_tap_tables_sum.launches = 0
