"""Evaluation metrics (behavior parity: the original implementation's
evaluation_utils.py:4-36).

The port's own copy of ``hplflownet_tpu/train/metrics.py``: float64 numpy on
host arrays, so the six metrics equal JAX's on the same predictions.
"""

from __future__ import annotations

import numpy as np

__all__ = ["evaluate_3d", "evaluate_2d"]


def evaluate_3d(sf_pred: np.ndarray, sf_gt: np.ndarray,
                valid: np.ndarray | None = None):
    """EPE3D / ACC3DS / ACC3DR / Outliers3D over (..., N, 3) flows."""
    sf_pred = np.asarray(sf_pred, dtype=np.float64)
    sf_gt = np.asarray(sf_gt, dtype=np.float64)
    l2 = np.linalg.norm(sf_gt - sf_pred, axis=-1)
    gt_norm = np.linalg.norm(sf_gt, axis=-1)
    rel = l2 / (gt_norm + 1e-4)

    if valid is not None:
        m = np.asarray(valid, bool).reshape(-1)
        l2 = l2.reshape(-1)[m]
        rel = rel.reshape(-1)[m]

    epe3d = l2.mean()
    acc_strict = np.logical_or(l2 < 0.05, rel < 0.05).astype(np.float64).mean()
    acc_relax = np.logical_or(l2 < 0.1, rel < 0.1).astype(np.float64).mean()
    outlier = np.logical_or(l2 > 0.3, rel > 0.1).astype(np.float64).mean()
    return float(epe3d), float(acc_strict), float(acc_relax), float(outlier)


def evaluate_2d(flow_pred: np.ndarray, flow_gt: np.ndarray,
                valid: np.ndarray | None = None):
    """EPE2D (px) / ACC2D over (..., N, 2) image-plane flows."""
    flow_pred = np.asarray(flow_pred, dtype=np.float64)
    flow_gt = np.asarray(flow_gt, dtype=np.float64)
    epe = np.linalg.norm(flow_gt - flow_pred, axis=-1)
    gt_norm = np.linalg.norm(flow_gt, axis=-1)
    rel = epe / (gt_norm + 1e-5)

    if valid is not None:
        m = np.asarray(valid, bool).reshape(-1)
        epe = epe.reshape(-1)[m]
        rel = rel.reshape(-1)[m]

    acc2d = np.logical_or(epe < 3.0, rel < 0.05).astype(np.float64).mean()
    return float(epe.mean()), float(acc2d)
