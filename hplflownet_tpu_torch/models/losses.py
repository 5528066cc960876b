"""Losses (port of ``hplflownet_tpu/models/losses.py``)."""

from __future__ import annotations

import torch

__all__ = ["epe3d_loss"]


def epe3d_loss(pred: torch.Tensor, target: torch.Tensor,
               valid: torch.Tensor | None = None) -> torch.Tensor:
    """Per-point end-point error ||pred - target||_2 over the channel axis.

    pred/target: (..., N, 3).  With ``valid`` (..., N) the mean is taken over
    valid points only (padding support); otherwise returns the per-point map
    (callers take ``.mean()``).
    """
    err = torch.linalg.vector_norm(pred - target, dim=-1)
    if valid is None:
        return err
    w = valid.to(err.dtype)
    return torch.sum(err * w) / torch.clamp_min(torch.sum(w), 1.0)
