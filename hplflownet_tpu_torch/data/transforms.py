"""Point-cloud transforms: eval-time sampling and train-time augmentation.

The port's own copy of ``hplflownet_tpu/data/transforms.py`` (numpy only):
the same draws from the same ``RandomState`` give the same samples.
Behavior parity with the original implementation's
transforms/transforms.py:494-664 (ProcessData, Augmentation), with one static-shape extension: when fewer
than ``num_points`` survive masking and ``allow_less_points`` is set, the
output is zero-padded to ``num_points`` with a validity mask instead of
returning a ragged array (the lattice builder and loss honor the mask).

Outputs are dicts of fixed-shape numpy arrays ready to stack into batches.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ProcessData", "Augmentation"]


def _mask_and_sample(pc1, pc2, sf, depth_threshold, no_corr, num_points,
                     allow_less_points, rng):
    """Near-mask + fixed-size sampling (reference :508-533, :617-648)."""
    if depth_threshold > 0:
        near_mask = np.logical_and(pc1[:, 2] < depth_threshold,
                                   pc2[:, 2] < depth_threshold)
    else:
        near_mask = np.ones(pc1.shape[0], dtype=bool)
    indices = np.where(near_mask)[0]
    if len(indices) == 0:
        return None

    if num_points > 0 and len(indices) >= num_points:
        idx1 = rng.choice(indices, size=num_points, replace=False)
        idx2 = rng.choice(indices, size=num_points, replace=False) \
            if no_corr else idx1
    elif num_points > 0:
        if not allow_less_points:
            return None
        idx1 = idx2 = indices
    else:
        idx1 = idx2 = indices

    n_out = num_points if num_points > 0 else len(idx1)

    def pad(x, idx):
        out = np.zeros((n_out,) + x.shape[1:], dtype=np.float32)
        out[: len(idx)] = x[idx]
        return out

    valid = np.zeros(n_out, dtype=bool)
    valid[: len(idx1)] = True
    return dict(
        pc1=pad(pc1[:, :3], idx1),
        pc2=pad(pc2[:, :3], idx2),
        sf=pad(sf, idx1),
        valid1=valid,
        valid2=valid.copy(),
    )


class ProcessData:
    """Eval path: ground-truth flow = pc2 - pc1, mask, sample (reference :494-539)."""

    def __init__(self, data_process_args, num_points, allow_less_points=False):
        self.depth_threshold = float(data_process_args["DEPTH_THRESHOLD"])
        self.no_corr = bool(data_process_args["NO_CORR"])
        self.num_points = int(num_points)
        self.allow_less_points = bool(allow_less_points)

    def __call__(self, data, rng=None):
        pc1, pc2 = data
        if pc1 is None:
            return None
        rng = rng or np.random
        sf = pc2[:, :3] - pc1[:, :3]
        return _mask_and_sample(pc1, pc2, sf, self.depth_threshold,
                                self.no_corr, self.num_points,
                                self.allow_less_points, rng)


class Augmentation:
    """Train path: shared scale/rot-Y/shift/jitter on both clouds, extra
    rigid motion + jitter on pc2, flow recomputed after the pc2-only motion
    (reference :551-649)."""

    def __init__(self, aug_together_args, aug_pc2_args, data_process_args,
                 num_points, allow_less_points=False):
        self.together = aug_together_args
        self.pc2_args = aug_pc2_args
        self.depth_threshold = float(data_process_args["DEPTH_THRESHOLD"])
        self.no_corr = bool(data_process_args["NO_CORR"])
        self.num_points = int(num_points)
        self.allow_less_points = bool(allow_less_points)

    def __call__(self, data, rng=None):
        pc1, pc2 = data
        if pc1 is None:
            return None
        rng = rng or np.random
        pc1 = pc1.copy()
        pc2 = pc2.copy()
        t = self.together

        # shared: scale, yaw rotation, shift, jitter
        scale = np.diag(rng.uniform(t["scale_low"], t["scale_high"], 3)
                        .astype(np.float32))
        angle = rng.uniform(-t["degree_range"], t["degree_range"])
        cosv, sinv = np.cos(angle), np.sin(angle)
        rot = np.array([[cosv, 0, sinv], [0, 1, 0], [-sinv, 0, cosv]],
                       dtype=np.float32)
        matrix = scale.dot(rot.T)
        shifts = rng.uniform(-t["shift_range"], t["shift_range"],
                             (1, 3)).astype(np.float32)
        jitter = np.clip(t["jitter_sigma"] * rng.randn(pc1.shape[0], 3),
                         -t["jitter_clip"], t["jitter_clip"]).astype(np.float32)
        bias = shifts + jitter
        pc1[:, :3] = pc1[:, :3].dot(matrix) + bias
        pc2[:, :3] = pc2[:, :3].dot(matrix) + bias

        # pc2-only: yaw rotation + shift, then flow, then jitter
        p = self.pc2_args
        angle2 = rng.uniform(-p["degree_range"], p["degree_range"])
        cosv2, sinv2 = np.cos(angle2), np.sin(angle2)
        rot2 = np.array([[cosv2, 0, sinv2], [0, 1, 0], [-sinv2, 0, cosv2]],
                        dtype=np.float32)
        shifts2 = rng.uniform(-p["shift_range"], p["shift_range"],
                              (1, 3)).astype(np.float32)
        pc2[:, :3] = pc2[:, :3].dot(rot2.T) + shifts2
        sf = pc2[:, :3] - pc1[:, :3]

        if not self.no_corr:
            jitter2 = np.clip(p["jitter_sigma"] * rng.randn(pc1.shape[0], 3),
                              -p["jitter_clip"],
                              p["jitter_clip"]).astype(np.float32)
            pc2[:, :3] += jitter2

        return _mask_and_sample(pc1, pc2, sf, self.depth_threshold,
                                self.no_corr, self.num_points,
                                self.allow_less_points, rng)
