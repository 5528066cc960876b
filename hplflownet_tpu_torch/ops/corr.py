"""Correlation BCL: cross-cloud patch correlation on the lattice (forward).

Port of the forward half of ``hplflownet_tpu/ops/corr.py``.  The first
correlation conv is linear before its activation, so it splits into a
*self* term (the same for every displacement f) and a *cross* term:

    y[f] = act(spread1 @ W_self + spread2[f] @ W_cross + b)

The self term is one 15-tap stencil contraction (``corr_self``); the F x Cc
displaced patches of the cross term collapse onto U = 65 unique combined
offsets, with the static (f, c) -> u map folded into the kernel ``k2``, so
the cross term is one 65-tap stencil with an F * W wide output
(``corr_cross``).  Both run through the ``stencil_gather_matmul`` kernel.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.stencil import stencil_gather_matmul
from .bcl import activation, dense, splat
from .segment import ReducePlan

__all__ = ["gather_rows", "corr_self", "corr_cross", "fold_cross_kernel",
           "BilateralCorrelation"]


def gather_rows(table_pad: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """``table_pad[indices + 1]``: row 0 is the zero row for absent ids."""
    return table_pad[(indices + 1).long()]


def corr_self(table_pad: torch.Tensor,   # (H1 + 1, C), row 0 zero
              indices: torch.Tensor,     # (Cc, H1) int32, -1 absent
              k_self: torch.Tensor,      # (Cc, C, W)
              bias: torch.Tensor,        # (W,) f32, fused into the epilogue
              ) -> torch.Tensor:
    """sum_k table_pad[indices[k] + 1] @ k_self[k] + bias -> (H1, W) f32."""
    return stencil_gather_matmul(table_pad[1:].contiguous(),
                                 indices.contiguous(), k_self.contiguous(),
                                 bias=bias)


def corr_cross(pad2: torch.Tensor,       # (H2 + 1, C)
               uniq_idx: torch.Tensor,   # (U, H1) unique-offset index rows
               k2: torch.Tensor,         # (U, C, F, W) folded kernel
               ) -> torch.Tensor:
    """cross[h, f, w] = sum_u pad2[uniq_idx[u, h] + 1] @ k2[u] -> (H1, F, W)."""
    u, c, f, w = k2.shape
    flat = stencil_gather_matmul(pad2[1:].contiguous(), uniq_idx.contiguous(),
                                 k2.reshape(u, c, f * w).contiguous())
    return flat.reshape(flat.shape[0], f, w)


def fold_cross_kernel(k_cross: torch.Tensor,   # (Cc, C, W)
                      inverse: torch.Tensor,   # (F, Cc) int32 -> u
                      n_uniq: int, dt: torch.dtype) -> torch.Tensor:
    """k2[u, :, f] = sum_{c : inverse[f, c] == u} k_cross[c] -> (U, C, F, W).

    For one f the combined offsets are distinct, so each (u, f) takes at
    most one term: the fold is an exact selection.
    """
    uid = torch.arange(n_uniq, dtype=inverse.dtype, device=inverse.device)
    onehot = (inverse[..., None] == uid).to(torch.float32)    # (F, Cc, U)
    return torch.einsum("fku,kcw->ucfw", onehot,
                        k_cross.to(torch.float32)).to(dt)


class BilateralCorrelation(nn.Module):
    """Patch correlation (``corr_widths``) + displacement filtering (``widths``).

    Parameter names and layouts match the flax module: ``corr0_kernel``
    ``(corr_size, self_dim + num_input, corr_widths[0])`` with input
    channels ordered [prev, feat1 | feat2], ``blur0_kernel``
    ``(filter_size, corr_widths[-1], widths[0])``, the rest pointwise.
    """

    def __init__(self, corr_widths: Sequence[int], widths: Sequence[int],
                 corr_size: int, filter_size: int, num_input: int,
                 prev_corr_dim: int = 0, use_norm: bool = True,
                 use_leaky: bool = True, last_relu: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.corr_widths = tuple(corr_widths)
        self.widths = tuple(widths)
        self.prev_corr_dim = prev_corr_dim
        self.use_norm = use_norm
        self.use_leaky = use_leaky
        self.last_relu = last_relu
        self.compute_dtype = compute_dtype
        self.self_dim = num_input + prev_corr_dim

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        cw, w = self.corr_widths, self.widths
        self.corr0_kernel = p(corr_size, self.self_dim + num_input, cw[0])
        self.corr0_bias = p(cw[0])
        for i in range(1, len(cw)):
            setattr(self, f"corr{i}_kernel", p(cw[i - 1], cw[i]))
            setattr(self, f"corr{i}_bias", p(cw[i]))
        self.blur0_kernel = p(filter_size, cw[-1], w[0])
        self.blur0_bias = p(w[0])
        for i in range(1, len(w)):
            setattr(self, f"blur{i}_kernel", p(w[i - 1], w[i]))
            setattr(self, f"blur{i}_bias", p(w[i]))

    def forward(self, feat1: torch.Tensor,        # (H1, C)
                feat2: torch.Tensor,              # (H2, C)
                prev_corr_feat,                   # (N_in, prev) or None
                barycentric1, splat_plan1: ReducePlan | None,
                pc1_corr_indices: torch.Tensor,   # (Cc, H1)
                pc2_corr_uniq: torch.Tensor,      # (U, H1)
                pc2_corr_inverse: torch.Tensor,   # (F, Cc) -> u
                ) -> torch.Tensor:
        dt = self.compute_dtype
        f32 = torch.float32
        c = feat1.shape[-1]
        pad1 = torch.cat([feat1.new_zeros(1, c), feat1])
        if self.prev_corr_dim:
            # splat the finer scale's correlation output onto this scale's
            # cloud-1 lattice
            prev_pad = splat(prev_corr_feat.to(dt), barycentric1, splat_plan1,
                             normalize=self.use_norm)
            combined1 = torch.cat([prev_pad.to(f32), pad1.to(f32)], dim=-1)
        else:
            combined1 = pad1
        pad2 = torch.cat([feat2.new_zeros(1, c), feat2])
        combined1 = combined1.to(dt)
        pad2 = pad2.to(dt)

        # ---- patch-correlation stage ----
        k_self = self.corr0_kernel[:, :self.self_dim, :].to(dt)
        k_cross = self.corr0_kernel[:, self.self_dim:, :]
        a_self = corr_self(combined1, pc1_corr_indices, k_self, self.corr0_bias)
        k2 = fold_cross_kernel(k_cross, pc2_corr_inverse,
                               pc2_corr_uniq.shape[0], dt)
        cross = corr_cross(pad2, pc2_corr_uniq, k2)
        y = activation(a_self[:, None, :] + cross, self.use_leaky)  # (H1, F, W)

        h1, nf, _ = y.shape
        for i in range(1, len(self.corr_widths)):
            k = getattr(self, f"corr{i}_kernel")
            y = dense(y.reshape(h1 * nf, -1), k, dt).reshape(h1, nf, -1)
            y = activation(y + getattr(self, f"corr{i}_bias"), self.use_leaky)

        # ---- displacement-filtering stage ----
        x = (dense(y.reshape(h1, -1), self.blur0_kernel.reshape(
            -1, self.widths[0]), dt) + self.blur0_bias)
        if len(self.widths) > 1 or self.last_relu:
            x = activation(x, self.use_leaky)
        x = x.to(dt)
        for i in range(1, len(self.widths)):
            x = dense(x, getattr(self, f"blur{i}_kernel"), dt) + getattr(
                self, f"blur{i}_bias")
            if i < len(self.widths) - 1 or self.last_relu:
                x = activation(x, self.use_leaky)
            x = x.to(dt)
        return x
