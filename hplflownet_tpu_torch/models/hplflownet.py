"""HPLFlowNet: the full 7-scale scene-flow model.

Port of ``hplflownet_tpu/models/hplflownet.py``: a 3-layer point MLP, a
7-scale splat-only BCL encoder over both clouds, correlation BCLs at scales
3..7 chained coarse-ward, a slice-only BCL decoder with skip
concatenations, and a 3-layer prediction head.  Submodule and parameter
names are the flax ones (``bcn1``, ``bcn1_``, ``corr1``, ``conv4``, ...),
so a JAX parameter tree maps onto ``state_dict`` keys one for one
(``hplflownet_tpu_torch.params``).  Differentiable through the ops'
hand-derived backward passes; a pyramid built with ``adjoint_plans=True``
carries the correlation inverse maps those need.

Single-sample, channels-last.  Runs on the CUDA card unless ``device`` says
otherwise; ``compute_dtype`` bfloat16 runs gathers and products in bf16 with
float32 accumulation, as the JAX bench does.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..device import resolve_device
from ..kernels.stencil_plan import make_stencil_plans
from ..lattice.offsets import filter_size, tap_negation
from ..ops.bcl import BilateralConv, local_columns
from ..ops.corr import BilateralCorrelation
from .layers import PointMLP

__all__ = ["HPLFlowNet", "stencil_plans"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           torch.float32: torch.float32, torch.bfloat16: torch.bfloat16}


def _cat(*xs):
    return torch.cat(xs, dim=-1)


def stencil_plans(scales, lists: bool = True) -> list:
    """Per scale, the stencil plan of each neighbour table the model reads
    (``kernels.stencil_plan``): ``pc1_blur`` and ``pc2_blur`` at every
    scale (the decoder reuses ``pc1_blur``), ``pc1_corr`` and ``pc2_corr``
    from scale 2 on, where both models correlate (2..6 in the 7-scale
    model, 2..4 in the shallow one).  Made once per pair, together
    (:func:`make_stencil_plans`: one sort per tap count); ``lists`` as
    there (the weight gradient's vertex lists).  Under
    ``ops.bcl.vertex_sharding`` each plan is of the rank's columns of its
    table, the ones the sharded op computes."""
    names, tables = [], []
    for s, sp in enumerate(scales):
        h1 = sp.pc1_splat_plan.start.shape[0]
        h2 = sp.pc2_splat_plan.start.shape[0]
        names += [(s, "pc1_blur"), (s, "pc2_blur")]
        tables += [(local_columns(sp.pc1_blur_neighbors), h1),
                   (local_columns(sp.pc2_blur_neighbors), h2)]
        if s >= 2:
            names += [(s, "pc1_corr"), (s, "pc2_corr")]
            tables += [(local_columns(sp.pc1_corr_indices), h1),
                       (local_columns(sp.pc2_corr_uniq), h2)]
    with torch.no_grad():
        made = make_stencil_plans(tables, lists)
    plans = [{} for _ in scales]
    for (s, name), plan in zip(names, made):
        plans[s][name] = plan
    return plans


class _LatticeFlowNet(nn.Module):
    """What both models share: the layer constructors over one
    ``scales_filter_map`` and the encoder / correlation / decoder calls
    over one pair's pyramid and stencil plans."""

    def __init__(self, scales_filter_map, num_scales: int, dim: int,
                 use_leaky: bool, bcn_use_bias: bool, bcn_use_norm: bool,
                 last_relu: bool, compute_dtype, device):
        super().__init__()
        assert len(scales_filter_map) == num_scales, \
            f"{type(self).__name__} needs {num_scales} scales"
        self._sfm = [list(row) for row in scales_filter_map]
        self._dim = dim
        self._flags = dict(use_leaky=use_leaky, bcn_use_bias=bcn_use_bias,
                           bcn_use_norm=bcn_use_norm, last_relu=last_relu)
        self._device = resolve_device(device)
        self.compute_dtype = _DTYPES[compute_dtype]

    def _fs(self, radius) -> int:
        return filter_size(int(radius), self._dim)

    def _bcn(self, i, widths, num_input, do_splat):
        f, radius = self._flags, int(self._sfm[i][1])
        return BilateralConv(widths, self._fs(radius), num_input,
                             do_splat=do_splat, do_slice=not do_splat,
                             use_norm=f["bcn_use_norm"],
                             use_bias=f["bcn_use_bias"],
                             use_leaky=f["use_leaky"],
                             last_relu=f["last_relu"],
                             compute_dtype=self.compute_dtype,
                             tap_negation=tap_negation(radius, self._dim),
                             device=self._device)

    def _corr(self, i, corr_widths, widths, prev_dim):
        f = self._flags
        return BilateralCorrelation(corr_widths, widths,
                                    self._fs(self._sfm[i][3]),
                                    self._fs(self._sfm[i][2]), 64,
                                    prev_corr_dim=prev_dim,
                                    use_norm=f["bcn_use_norm"],
                                    use_leaky=f["use_leaky"],
                                    last_relu=f["last_relu"],
                                    compute_dtype=self.compute_dtype,
                                    corr_tap_negation=tap_negation(
                                        int(self._sfm[i][3]), self._dim),
                                    device=self._device)

    def _mlp(self, widths, in_dim, last_act: bool = True):
        return PointMLP(widths, in_dim, use_leaky=self._flags["use_leaky"],
                        last_act=last_act, compute_dtype=self.compute_dtype,
                        device=self._device)

    def _emg1(self, sp):
        # el_minus_gr is builder data (f32); cast once so the decoder
        # concats stay in the compute dtype
        return sp.pc1_el_minus_gr.to(self.compute_dtype)

    def _down(self, mod, scales, plans, s, f1, f2):
        sp = scales[s]
        o1 = mod(_cat(self._emg1(sp), f1), in_barycentric=sp.pc1_barycentric,
                 splat_plan=sp.pc1_splat_plan,
                 blur_neighbors=sp.pc1_blur_neighbors,
                 blur_plan=plans[s]["pc1_blur"])
        o2 = mod(_cat(sp.pc2_el_minus_gr.to(self.compute_dtype), f2),
                 in_barycentric=sp.pc2_barycentric,
                 splat_plan=sp.pc2_splat_plan,
                 blur_neighbors=sp.pc2_blur_neighbors,
                 blur_plan=plans[s]["pc2_blur"])
        return o1, o2

    def _correlate(self, mod, scales, plans, s, f1, f2, prev):
        sp = scales[s]
        return mod(f1, f2, prev, sp.pc1_barycentric, sp.pc1_splat_plan,
                   sp.pc1_corr_indices, sp.pc2_corr_uniq,
                   sp.pc2_corr_inverse, sp.pc2_corr_uniq_inv,
                   self_plan=plans[s]["pc1_corr"],
                   cross_plan=plans[s]["pc2_corr"])

    def _up(self, mod, scales, plans, feats, s):
        # blur on scale s's lattice, slice onto scale s's points
        sp = scales[s]
        return mod(feats, blur_neighbors=sp.pc1_blur_neighbors,
                   out_barycentric=sp.pc1_barycentric,
                   out_lattice_offset=sp.pc1_lattice_offset,
                   out_splat_plan=sp.pc1_splat_plan,
                   blur_plan=plans[s]["pc1_blur"])


class HPLFlowNet(_LatticeFlowNet):
    """Args mirror the JAX module's (and the reference's config surface)."""

    def __init__(self, scales_filter_map: Sequence[Sequence[float]],
                 dim: int = 3, use_leaky: bool = True,
                 bcn_use_bias: bool = True, bcn_use_norm: bool = True,
                 last_relu: bool = False, compute_dtype="float32",
                 device=None):
        super().__init__(scales_filter_map, 7, dim, use_leaky, bcn_use_bias,
                         bcn_use_norm, last_relu, compute_dtype, device)
        d1 = dim + 1
        self.conv1 = self._mlp((32, 32, 64), dim)
        for i in range(7):
            setattr(self, f"bcn{i + 1}", self._bcn(i, (64, 64), d1 + 64, True))
        # decoder input widths: [emg (d1) | decoder out | corr out | skip]
        dec = [(1024, d1 + 512 + 64), (512, d1 + 256 + 64),
               (256, d1 + 256 + 64 + 64), (256, d1 + 128 + 64 + 64),
               (128, d1 + 128 + 64 + 64), (128, d1 + 128 + 64 + 64),
               (128, 64 + 64)]
        for i, (w, c_in) in enumerate(dec):
            setattr(self, f"bcn{i + 1}_", self._bcn(i, (w, w), c_in, False))
        for k, prev in enumerate((0, 64, 64, 64, 64)):
            setattr(self, f"corr{k + 1}",
                    self._corr(k + 2, (32, 32), (64, 64), prev))
        self.conv2 = self._mlp((1024,), 1024)
        self.conv3 = self._mlp((512,), 1024)
        self.conv4 = self._mlp((3,), 512, last_act=False)

    def forward(self, pc1: torch.Tensor, pc2: torch.Tensor, scales) -> torch.Tensor:
        """pc1, pc2: (N, dim) points; scales: the 7 ``ScalePair`` tables.

        Returns the (N, 3) float32 scene flow of pc1.
        """
        plans = stencil_plans(scales, lists=torch.is_grad_enabled())
        emg1 = self._emg1

        def down(mod, s, f1, f2):
            return self._down(mod, scales, plans, s, f1, f2)

        def correlate(mod, s, f1, f2, prev):
            return self._correlate(mod, scales, plans, s, f1, f2, prev)

        def up(mod, feats, s):
            return self._up(mod, scales, plans, feats, s)

        feat1 = self.conv1(pc1)
        feat2 = self.conv1(pc2)
        p1o1, p2o1 = down(self.bcn1, 0, feat1, feat2)
        p1o2, p2o2 = down(self.bcn2, 1, p1o1, p2o1)
        p1o3, p2o3 = down(self.bcn3, 2, p1o2, p2o2)
        c1 = correlate(self.corr1, 2, p1o3, p2o3, None)
        p1o4, p2o4 = down(self.bcn4, 3, p1o3, p2o3)
        c2 = correlate(self.corr2, 3, p1o4, p2o4, c1)
        p1o5, p2o5 = down(self.bcn5, 4, p1o4, p2o4)
        c3 = correlate(self.corr3, 4, p1o5, p2o5, c2)
        p1o6, p2o6 = down(self.bcn6, 5, p1o5, p2o5)
        c4 = correlate(self.corr4, 5, p1o6, p2o6, c3)
        p1o7, p2o7 = down(self.bcn7, 6, p1o6, p2o6)
        c5 = correlate(self.corr5, 6, p1o7, p2o7, c4)

        out = up(self.bcn7_, _cat(c5, p1o7), 6)
        out = up(self.bcn6_, _cat(emg1(scales[6]), out, c4, p1o6), 5)
        out = up(self.bcn5_, _cat(emg1(scales[5]), out, c3, p1o5), 4)
        out = up(self.bcn4_, _cat(emg1(scales[4]), out, c2, p1o4), 3)
        out = up(self.bcn3_, _cat(emg1(scales[3]), out, c1, p1o3), 2)
        out = up(self.bcn2_, _cat(emg1(scales[2]), out, p1o2), 1)
        out = up(self.bcn1_, _cat(emg1(scales[1]), out, p1o1), 0)

        res = self.conv2(out)
        res = self.conv3(res)
        return self.conv4(res)
