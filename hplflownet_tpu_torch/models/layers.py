"""Pointwise MLPs (the reference's Conv1dReLU stacks), channels-last.

Port of ``hplflownet_tpu/models/layers.py``.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..ops.bcl import dense, slope_of

__all__ = ["PointMLP"]


class PointMLP(nn.Module):
    """Dense + activation layers over (N, C) features.

    Parameters ``dense{i}_kernel`` ``(in, out)`` and ``dense{i}_bias``, as
    in flax.  ``last_act=False`` leaves the final layer linear and its
    output float32 (the flow head); other activations are stored in the
    compute dtype.
    """

    def __init__(self, widths: Sequence[int], in_dim: int,
                 use_leaky: bool = True, last_act: bool = True,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.widths = tuple(widths)
        self.use_leaky = use_leaky
        self.last_act = last_act
        self.compute_dtype = compute_dtype
        dims = (in_dim,) + self.widths
        for i, w in enumerate(self.widths):
            setattr(self, f"dense{i}_kernel",
                    nn.Parameter(torch.zeros(dims[i], w, device=device)))
            setattr(self, f"dense{i}_bias",
                    nn.Parameter(torch.zeros(w, device=device)))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        for i in range(len(self.widths)):
            on = i < len(self.widths) - 1 or self.last_act
            x = dense(x, getattr(self, f"dense{i}_kernel"),
                      getattr(self, f"dense{i}_bias"),
                      slope_of(self.use_leaky) if on else None,
                      dt if on else torch.float32, dt)
        return x
