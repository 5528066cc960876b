"""Pinhole projection of 3D flow into the image plane.

Behavior parity with the original implementation's utils/geometry.py:6-65:
FlyingThings3D uses fixed intrinsics (f=-1050, cx=479.5, cy=269.5);
KITTI reads the per-frame ``P_rect_02`` rectified projection matrix from a
calib directory, by default the 200 files that ship with the JAX package (read in place).
The port's own copy of ``hplflownet_tpu/train/geometry2d.py``.
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from ..data.io import SHIPPED_DATA_DIR

__all__ = ["project_3d_to_2d", "get_batch_2d_flow", "read_kitti_calib",
           "CALIB_ROOT"]

CALIB_ROOT = osp.join(SHIPPED_DATA_DIR, "calib_cam_to_cam")
FT3D_INTRINSICS = dict(f=-1050.0, cx=479.5, cy=269.5)


def project_3d_to_2d(pc, f=-1050.0, cx=479.5, cy=269.5,
                     constx=0.0, consty=0.0, constz=0.0):
    x = (pc[..., 0] * f + cx * pc[..., 2] + constx) / (pc[..., 2] + constz)
    y = (pc[..., 1] * f + cy * pc[..., 2] + consty) / (pc[..., 2] + constz)
    return x, y


def read_kitti_calib(calib_path: str) -> dict:
    """Parse P_rect_02 from a KITTI cam-to-cam calib file."""
    with open(calib_path) as fd:
        for line in fd:
            if line.startswith("P_rect_02"):
                vals = np.array([float(v) for v in line.split()[1:]],
                                dtype=np.float32).reshape(3, 4)
                return dict(f=-vals[0, 0], cx=vals[0, 2], cy=vals[1, 2],
                            constx=vals[0, 3], consty=vals[1, 3],
                            constz=vals[2, 3])
    raise ValueError(f"no P_rect_02 in {calib_path}")


def get_batch_2d_flow(pc1, pc2, predicted_pc2, paths, calib_root=None):
    """Project (B, N, 3) clouds to 2D and return (flow_pred, flow_gt).

    ``paths`` decide the intrinsics: KITTI frames look up per-frame calib
    files named <frame>.txt under ``calib_root``; anything else uses the
    fixed FlyingThings3D intrinsics.
    """
    if paths and ("KITTI" in paths[0] or "kitti" in paths[0]):
        if calib_root is None:
            calib_root = CALIB_ROOT
        intr = [read_kitti_calib(osp.join(calib_root,
                                          osp.split(p)[-1] + ".txt"))
                for p in paths]
        kw = {k: np.array([i[k] for i in intr])[:, None]
              for k in ("f", "cx", "cy", "constx", "consty", "constz")}
    else:
        kw = dict(FT3D_INTRINSICS)

    px1, py1 = project_3d_to_2d(pc1, **kw)
    px2, py2 = project_3d_to_2d(predicted_pc2, **kw)
    px2_gt, py2_gt = project_3d_to_2d(pc2, **kw)

    flow_pred = np.stack([px2 - px1, py2 - py1], axis=-1)
    flow_gt = np.stack([px2_gt - px1, py2_gt - py1], axis=-1)
    return flow_pred, flow_gt
