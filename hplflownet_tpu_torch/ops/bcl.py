"""Bilateral Convolution Layer (BCL): splat -> blur -> slice (forward).

Port of the forward half of ``hplflownet_tpu/ops/bcl.py``:

* ``splat``: barycentric-weighted reduction of point features onto lattice
  vertices through the lattice build's splat plan, normalised by
  ``1 / (density + 1e-5)``; the run sums go through the ``rank_reduce``
  kernel on CUDA.
* ``blur``: the multi-tap stencil conv through the
  ``stencil_gather_matmul`` kernel, with the bias, activation and output
  cast fused into its epilogue.
* ``slice_to_points``: each point's d+1 vertices, barycentric-weighted;
  absent vertices (id -1) get weight zero.
* ``BilateralConv``: the module, with the flax parameter names and layouts
  (``conv0_kernel`` is ``(F, C_in, C_out)``).

Single-sample, channels-last.  Vertex id -1 is absent; every vertex table
passed between layers carries a zero row 0 (ids shifted by +1).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels.stencil import stencil_gather_matmul
from .segment import ReducePlan, weighted_reduce

__all__ = ["splat", "blur", "slice_to_points", "BilateralConv",
           "LEAKY_RATE", "NORM_EPS", "activation", "dense"]

LEAKY_RATE = 0.1
NORM_EPS = 1e-5


def activation(x: torch.Tensor, use_leaky: bool) -> torch.Tensor:
    """LeakyReLU(0.1) (``x >= 0 ? x : 0.1 x``) or ReLU, as jax.nn does it."""
    if use_leaky:
        return torch.where(x >= 0, x, LEAKY_RATE * x)
    return torch.clamp_min(x, 0)


def dense(x: torch.Tensor, k: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """``x @ k`` with both rounded to ``dt`` and a float32 result.

    The products of bf16 values are exact in float32, so a float32 matmul
    of the rounded operands is "bf16 inputs, float32 accumulation".
    """
    f32 = torch.float32
    return x.to(dt).to(f32) @ k.to(dt).to(f32)


def splat(features: torch.Tensor,     # (N, C)
          barycentric: torch.Tensor,  # (N, d1)
          plan: ReducePlan,
          normalize: bool = True) -> torch.Tensor:
    """(H + 1, C) float32 vertex features; row 0 is the zero sentinel row."""
    c = features.shape[-1]
    out = weighted_reduce(normalize, plan, features, barycentric)  # (H, C[+1])
    if normalize:
        out = out[:, :c] * (1.0 / (out[:, c] + NORM_EPS))[:, None]
    return torch.cat([out.new_zeros(1, c), out], dim=0)


def blur(splatted_pad: torch.Tensor,   # (H + 1, C_in), row 0 zero
         neighbors: torch.Tensor,      # (F, H) int32, -1 absent
         kernel: torch.Tensor,         # (F, C_in, C_out)
         bias: torch.Tensor | None,    # (C_out,) f32
         act_slope: float | None,
         out_dtype: torch.dtype) -> torch.Tensor:
    """act(stencil conv + bias) over the lattice -> (H, C_out)."""
    return stencil_gather_matmul(splatted_pad[1:].contiguous(),
                                 neighbors.contiguous(), kernel.contiguous(),
                                 bias=bias, act_slope=act_slope,
                                 out_dtype=out_dtype)


def slice_to_points(blurred: torch.Tensor,             # (H, C)
                    out_barycentric: torch.Tensor,     # (N, d1) f32
                    out_lattice_offset: torch.Tensor,  # (N, d1) int32
                    ) -> torch.Tensor:
    """Barycentric combination of each point's d+1 vertices -> (N, C) f32.

    Id -1 marks an absent vertex: an invalid point (zero weight already) or
    a valid point whose vertex overflowed capacity (nonzero weight) — the
    clamp would alias the latter onto row 0, a real vertex, so its weight
    is zeroed here.
    """
    h = blurred.shape[0]
    bary = torch.where(out_lattice_offset >= 0, out_barycentric, 0.0)
    out = None
    for r in range(out_lattice_offset.shape[1]):
        safe = out_lattice_offset[:, r].clamp(0, h - 1).long()
        term = bary[:, r, None] * blurred[safe].to(torch.float32)
        out = term if out is None else out + term
    return out


class BilateralConv(nn.Module):
    """BCL with an optional splat front-end and slice back-end.

    ``widths``: conv widths; the first conv contracts the stencil axis
    (``conv0_kernel`` of shape ``(filter_size, num_input, widths[0])``),
    the rest are pointwise (``conv{i}_kernel`` of shape ``(in, out)``).
    Parameter names match the flax module one for one.
    """

    def __init__(self, widths: Sequence[int], filter_size: int,
                 num_input: int, do_splat: bool, do_slice: bool,
                 use_norm: bool = True, use_bias: bool = True,
                 use_leaky: bool = True, last_relu: bool = False,
                 compute_dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.widths = tuple(widths)
        self.do_splat = do_splat
        self.do_slice = do_slice
        self.use_norm = use_norm
        self.use_bias = use_bias
        self.use_leaky = use_leaky
        self.last_relu = last_relu
        self.compute_dtype = compute_dtype

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.conv0_kernel = p(filter_size, num_input, self.widths[0])
        self.conv0_bias = p(self.widths[0])
        for i in range(1, len(self.widths)):
            setattr(self, f"conv{i}_kernel", p(self.widths[i - 1], self.widths[i]))
            setattr(self, f"conv{i}_bias", p(self.widths[i]))
        if do_slice and use_bias:
            self.slice_bias = p(self.widths[-1])

    def forward(self, features: torch.Tensor,  # (N_in, C) if splat else (H, C)
                in_barycentric=None, splat_plan: ReducePlan | None = None,
                blur_neighbors=None, out_barycentric=None,
                out_lattice_offset=None) -> torch.Tensor:
        dt = self.compute_dtype
        c = features.shape[-1]
        if self.do_splat:
            # cast before the splat: a bf16 stream moves half the bytes
            splatted_pad = splat(features.to(dt), in_barycentric, splat_plan,
                                 normalize=self.use_norm)
        else:
            splatted_pad = torch.cat([features.new_zeros(1, c), features])
        splatted_pad = splatted_pad.to(dt)

        if len(self.widths) > 1 or self.last_relu:
            slope = LEAKY_RATE if self.use_leaky else 0.0
        else:
            slope = None
        x = blur(splatted_pad, blur_neighbors, self.conv0_kernel.to(dt),
                 self.conv0_bias, slope, dt)

        for i in range(1, len(self.widths)):
            x = (dense(x, getattr(self, f"conv{i}_kernel"), dt)
                 + getattr(self, f"conv{i}_bias"))
            if i < len(self.widths) - 1 or self.last_relu:
                x = activation(x, self.use_leaky)
            x = x.to(dt)

        if not self.do_slice:
            return x
        sliced = slice_to_points(x, out_barycentric, out_lattice_offset)
        if self.use_bias:
            sliced = sliced + self.slice_bias
        return sliced.to(dt)
