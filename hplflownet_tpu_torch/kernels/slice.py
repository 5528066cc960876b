"""``slice_points``: the slice back to points, with its bias and cast.

    out[n, c] = cast(((w0 v0 + w1 v1) + w2 v2) + w3 v3 [+ bias[c]])

``v_r`` is row ``ids[n, r]`` of the (H, C) vertex table in float32, ``w_r``
is ``bary[n, r]``, or 0 where the id is -1 (an absent vertex); products and
sums are float32, in vertex order, and the cast rounds to nearest even.

Replaces no Pallas kernel: the JAX package leaves the slice to XLA
(``hplflownet_tpu/ops/bcl.py:290-337``).  On CUDA tensors the wrapper
launches ``csrc/slice_points.cu`` (one launch for what the plain version
does in some 26); on CPU tensors, and under ``plain_kernels()``, it runs
:func:`slice_points_plain`, the composition the BCL ran before.  The two
agree value for value.  The kernel source states its bound on the card and
what its design does about it.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry

__all__ = ["slice_points", "slice_points_plain", "MAX_VERTICES"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_VERTICES = 8     # d + 1 of a lattice of up to 7 dimensions


def slice_points_plain(table, bary, ids, bias=None, out_dtype=torch.float32):
    """Plain PyTorch version: per vertex a clamped row gather, widened to
    float32, times its weight (zeroed where the id is -1), summed in vertex
    order; then the bias and the cast."""
    h = table.shape[0]
    w = torch.where(ids >= 0, bary, 0.0)
    out = None
    for r in range(ids.shape[1]):
        safe = ids[:, r].clamp(0, h - 1).long()
        term = w[:, r, None] * table[safe].to(torch.float32)
        out = term if out is None else out + term
    if bias is not None:
        out = out + bias
    return out.to(out_dtype)


def _check_args(table, bary, ids, bias, out_dtype):
    if table.dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"table and out_dtype must be float32 or bfloat16, "
                        f"got {table.dtype} and {out_dtype}")
    if table.dim() != 2 or table.shape[0] == 0:
        raise ValueError(f"expected a (rows, C) table, got {tuple(table.shape)}")
    if ids.dtype != torch.int32 or ids.dim() != 2:
        raise TypeError("ids must be a 2-D int32 tensor")
    if not 1 <= ids.shape[1] <= MAX_VERTICES:
        raise ValueError(f"at most {MAX_VERTICES} vertices a point, got "
                         f"{ids.shape[1]}")
    if bary.dtype != torch.float32 or bary.shape != ids.shape:
        raise ValueError(f"bary must be float32 of the ids' shape "
                         f"{tuple(ids.shape)}, got {bary.dtype} "
                         f"{tuple(bary.shape)}")
    if bias is not None and (bias.dtype != torch.float32
                             or bias.shape != (table.shape[1],)):
        raise ValueError("bias must be float32 of shape (C,)")
    for t in (table, bary, ids) + (() if bias is None else (bias,)):
        if t.device != table.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def slice_points(table: torch.Tensor,    # (H, C) float32 or bf16
                 bary: torch.Tensor,     # (N, d1) f32
                 ids: torch.Tensor,      # (N, d1) int32, -1 absent
                 bias: torch.Tensor | None = None,   # (C,) f32
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Each point's barycentric combination of its vertex rows, plus
    ``bias``, -> (N, C) in ``out_dtype``."""
    if table.device.type == "cpu" or plain_forced():
        return slice_points_plain(table, bary, ids, bias, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    _check_args(table, bary, ids, bias, out_dtype)
    (h, c), (n, d1) = table.shape, ids.shape
    out = torch.empty((n, c), dtype=out_dtype, device=table.device)
    fn = entry("slice_points", "hpl_slice_points", "piiippiippip")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.data_ptr(), h, c, _DTYPES[table.dtype], bary.data_ptr(),
            ids.data_ptr(), n, d1, bias.data_ptr() if bias is not None else None,
            out.data_ptr(), _DTYPES[out_dtype], stream)
    check("slice_points", rc, "slice_points launch")
    slice_points.launches += 1
    return out


slice_points.launches = 0
