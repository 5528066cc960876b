"""HPLFlowNetShallow: the 5-scale light variant.

Port of ``hplflownet_tpu/models/hplflownet_shallow.py``: single-conv BCL
stacks (64 wide), correlation BCLs at scales 3..5 with 32-wide outputs,
each followed by a point-MLP refinement, and a 128 -> 1024 -> 512 -> 3
head.  Parameter names are the flax ones (``bcn1``, ``bcn5_``, ``corr1``,
``corr1_refine``, ``conv4``, ...), as in :class:`HPLFlowNet`.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .hplflownet import _LatticeFlowNet, _cat

__all__ = ["HPLFlowNetShallow"]


class HPLFlowNetShallow(_LatticeFlowNet):
    """Args mirror the JAX module's; ``device`` as :class:`HPLFlowNet`'s."""

    def __init__(self, scales_filter_map: Sequence[Sequence[float]],
                 dim: int = 3, use_leaky: bool = True,
                 bcn_use_bias: bool = True, bcn_use_norm: bool = True,
                 last_relu: bool = False, compute_dtype="float32",
                 device=None):
        super().__init__(scales_filter_map, 5, dim, use_leaky, bcn_use_bias,
                         bcn_use_norm, last_relu, compute_dtype, device)
        d1 = dim + 1
        self.conv1 = self._mlp((32, 32, 64), dim)
        for i in range(5):
            setattr(self, f"bcn{i + 1}", self._bcn(i, (64,), d1 + 64, True))
        # decoder input widths: [emg (d1) | decoder out | corr out | skip]
        dec = [(128, d1 + 64 + 64), (64, d1 + 64 + 64),
               (64, d1 + 64 + 64 + 64), (64, d1 + 64 + 64 + 64),
               (64, 64 + 64)]
        for i in reversed(range(5)):
            w, c_in = dec[i]
            setattr(self, f"bcn{i + 1}_", self._bcn(i, (w,), c_in, False))
        for k, prev in enumerate((0, 64, 64)):
            setattr(self, f"corr{k + 1}", self._corr(k + 2, (32,), (32,), prev))
        # corr1/2_refine read the next scale's el_minus_gr, corr3_refine none
        for k, c_in in enumerate((d1 + 32, d1 + 32, 32)):
            setattr(self, f"corr{k + 1}_refine", self._mlp((64, 64, 64), c_in))
        self.conv2 = self._mlp((1024,), 128)
        self.conv3 = self._mlp((512,), 1024)
        self.conv4 = self._mlp((3,), 512, last_act=False)

    def _flow(self, pc1, pc2, scales, plans) -> torch.Tensor:
        emg1 = self._emg1

        def down(mod, s, f1, f2):
            return self._down(mod, scales, plans, s, f1, f2)

        def correlate(mod, s, f1, f2, prev):
            return self._correlate(mod, scales, plans, s, f1, f2, prev)

        def up(mod, feats, s):
            return self._up(mod, scales, plans, feats, s)

        feat1, feat2 = self._embed(pc1, pc2)
        p1o1, p2o1 = down(self.bcn1, 0, feat1, feat2)
        p1o2, p2o2 = down(self.bcn2, 1, p1o1, p2o1)
        p1o3, p2o3 = down(self.bcn3, 2, p1o2, p2o2)
        c1 = correlate(self.corr1, 2, p1o3, p2o3, None)
        c1 = self.corr1_refine(_cat(emg1(scales[3]), c1))
        p1o4, p2o4 = down(self.bcn4, 3, p1o3, p2o3)
        c2 = correlate(self.corr2, 3, p1o4, p2o4, c1)
        c2 = self.corr2_refine(_cat(emg1(scales[4]), c2))
        p1o5, p2o5 = down(self.bcn5, 4, p1o4, p2o4)
        c3 = correlate(self.corr3, 4, p1o5, p2o5, c2)
        c3 = self.corr3_refine(c3)

        out = up(self.bcn5_, _cat(c3, p1o5), 4)
        out = up(self.bcn4_, _cat(emg1(scales[4]), out, c2, p1o4), 3)
        out = up(self.bcn3_, _cat(emg1(scales[3]), out, c1, p1o3), 2)
        out = up(self.bcn2_, _cat(emg1(scales[2]), out, p1o2), 1)
        out = up(self.bcn1_, _cat(emg1(scales[1]), out, p1o1), 0)

        return self._head(out)
