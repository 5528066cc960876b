"""``row_take``: out[i] = table[idx[i]], a row gather.

Replaces ``tools/gather_experiments.py`` ``pallas_take`` (:76; ``pallas_call``
:77, body ``take_kernel`` :73), the gather lab's in-VMEM take of a (H + 1,
128) bf16 table.  On CUDA tensors the wrapper launches ``csrc/row_take.cu``
(one warp per row, 16-byte vector loads); on CPU tensors it runs
:func:`row_take_plain`.  Indices outside [0, rows) are clamped to the
nearest row, in both versions.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry

__all__ = ["row_take", "row_take_plain"]

_DTYPES = (torch.float32, torch.bfloat16)


def row_take_plain(table, idx):
    """Plain PyTorch version: ``index_select`` of the clamped indices."""
    return table.index_select(0, idx.long().clamp(0, table.shape[0] - 1))


def _check_args(table, idx):
    if table.dtype not in _DTYPES:
        raise TypeError(f"table must be float32 or bfloat16, got {table.dtype}")
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise TypeError("idx must be a 1-D int32 tensor")
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"expected a (rows, C) table, got {tuple(table.shape)}")
    for t in (table, idx):
        if t.device != table.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def row_take(table: torch.Tensor,    # (rows, C)
             idx: torch.Tensor       # (H,) int32
             ) -> torch.Tensor:
    """table[idx] -> (H, C) in the table's dtype."""
    if table.device.type == "cpu" or plain_forced():
        return row_take_plain(table, idx)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    _check_args(table, idx)
    rows, c = table.shape
    n = idx.shape[0]
    out = torch.empty((n, c), dtype=table.dtype, device=table.device)
    fn = entry("row_take", "hpl_row_take", "piipipp")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.data_ptr(), rows, c * table.element_size(), idx.data_ptr(),
            n, out.data_ptr(), stream)
    check("row_take", rc, "row_take launch")
    row_take.launches += 1
    return out


row_take.launches = 0
