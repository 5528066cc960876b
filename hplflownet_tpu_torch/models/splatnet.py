"""SPLATNet3D: per-point part labels from one cloud over five lattices.

The segmentation network of Su et al., "SPLATNet: Sparse Lattice Networks
for Point Cloud Processing" (CVPR 2018, Fig. 3; github.com/NVlabs/splatnet):

* a 1x1 conv (``conv1``) of 32 channels on the points' xyz;
* five BCLs (``bcl1`` .. ``bcl5``, 64, 128, 256, 256 and 256 wide).  BCL k
  splats the points' current features onto the cloud's own lattice at
  scale k of the lattice spec (``lattice.build.build_scales``: each scale
  elevated from the points themselves), convolves over the 15-tap
  1-neighbourhood and slices back to every point.  Its one bias is the
  blur's (``conv0_bias``); there is no slice bias;
* BatchNorm and ReLU after every conv and BCL but the last conv;
* the five BCL outputs concatenated (960 channels), a 1x1 conv of 128
  (``conv2``), and the classifier (``conv3``, no norm, no activation).

Inference only: BatchNorm is the per-channel affine of its running
statistics, ``gamma * (x - mean) / sqrt(var + 1e-5) + beta``, on the
points (:class:`PointBatchNorm`).  Channels-last, one cloud;
``compute_dtype`` bfloat16 runs the gathers and products in bf16 with
float32 sums, as the flow models do.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.stencil_plan import make_stencil_plans
from ..lattice.offsets import filter_size, tap_negation
from ..ops.bcl import BilateralConv
from ..utils.profiling import span
from .hplflownet import _DTYPES
from .layers import PointMLP

__all__ = ["SPLATNet3D", "PointBatchNorm", "BN_EPS", "stencil_plans"]

BN_EPS = 1e-5


class PointBatchNorm(nn.Module):
    """BatchNorm at inference over (N, C) points, then ReLU, in float32;
    the result is cast to ``out_dtype``.  ``gamma`` and ``beta`` are
    parameters, ``mean`` and ``var`` the running statistics (buffers)."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(channels, device=device))
        self.beta = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("mean", torch.zeros(channels, device=device))
        self.register_buffer("var", torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
        scale = self.gamma * torch.rsqrt(self.var + BN_EPS)
        shift = self.beta - self.mean * scale
        return torch.addcmul(shift, x, scale).relu_().to(out_dtype)


def stencil_plans(scales, lists: bool = True) -> list:
    """The stencil plan of each scale's blur table (``CloudScale``s of one
    cloud), made together (``kernels.stencil_plan.make_stencil_plans``)."""
    with torch.no_grad():
        return make_stencil_plans(
            [(sc.blur_neighbors, sc.cloud.splat_plan.start.shape[0])
             for sc in scales], lists)


class SPLATNet3D(nn.Module):
    """``scales_filter_map`` rows ``[scale, blur_radius, -1, -1]``, one per
    BCL; the widths and the class count are the published ones unless
    given.  ``device`` as the flow models': the CUDA card unless it says
    otherwise."""

    def __init__(self, scales_filter_map: Sequence[Sequence[float]],
                 dim: int = 3, embed_width: int = 32,
                 bcl_widths: Sequence[int] = (64, 128, 256, 256, 256),
                 head_width: int = 128, classes: int = 50,
                 compute_dtype="float32", device=None):
        super().__init__()
        if len(scales_filter_map) != len(bcl_widths):
            raise ValueError(f"{len(bcl_widths)} BCLs need as many scales, got "
                             f"{len(scales_filter_map)}")
        device = resolve_device(device)
        self.compute_dtype = dt = _DTYPES[compute_dtype]
        self.conv1 = PointMLP((embed_width,), dim, last_act=False,
                              compute_dtype=dt, device=device)
        self.conv1_bn = PointBatchNorm(embed_width, device)
        c_in = embed_width
        for k, (row, width) in enumerate(zip(scales_filter_map, bcl_widths), 1):
            radius = int(row[1])
            setattr(self, f"bcl{k}", BilateralConv(
                (width,), filter_size(radius, dim), c_in, do_splat=True,
                do_slice=True, use_norm=True, use_bias=False,
                compute_dtype=dt, tap_negation=tap_negation(radius, dim),
                device=device))
            setattr(self, f"bcl{k}_bn", PointBatchNorm(width, device))
            c_in = width
        self.conv2 = PointMLP((head_width,), sum(bcl_widths), last_act=False,
                              compute_dtype=dt, device=device)
        self.conv2_bn = PointBatchNorm(head_width, device)
        self.conv3 = PointMLP((classes,), head_width, last_act=False,
                              compute_dtype=dt, device=device)

    def forward(self, points: torch.Tensor, scales) -> torch.Tensor:
        """points: (N, dim); scales: one ``CloudScale`` per BCL
        (``lattice.build.build_scales``) -> (N, classes) float32 logits.

        Inside ``utils.profiling.tracing()`` it marks ``model.forward`` and,
        in it, ``stencil.plans``, ``model.embed``, ``model.bcl<k>`` (k = 1
        .. 5, each with its BCL's ``model.splat``, ``model.blur`` and
        ``model.slice``) and ``model.head``.
        """
        dt = self.compute_dtype
        with span("model.forward"):
            with span("stencil.plans"):
                plans = stencil_plans(scales, lists=torch.is_grad_enabled())
            with span("model.embed"):
                x = self.conv1_bn(self.conv1(points), dt)
            outs = []
            for k, (sc, plan) in enumerate(zip(scales, plans), 1):
                cl = sc.cloud
                with span(f"model.bcl{k}"):
                    y = getattr(self, f"bcl{k}")(
                        x, in_barycentric=cl.barycentric,
                        splat_plan=cl.splat_plan,
                        blur_neighbors=sc.blur_neighbors,
                        out_barycentric=cl.barycentric,
                        out_lattice_offset=cl.lattice_offset,
                        out_splat_plan=cl.splat_plan, blur_plan=plan)
                    x = getattr(self, f"bcl{k}_bn")(y, dt)
                outs.append(x)
            with span("model.head"):
                h = self.conv2_bn(self.conv2(torch.cat(outs, dim=1)), dt)
                return self.conv3(h)
