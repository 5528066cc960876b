"""KITTI Scene Flow 2015 preprocessing: disparity/flow PNGs -> point clouds.

The port's copy of ``hplflownet_tpu/data/preprocess/kitti.py``, writing the
same ``pc1.npy`` / ``pc2.npy`` bytes.  Per frame it converts disp_occ_0 /
disp_occ_1 to depth (baseline 0.54 m), advects pixels by flow_occ,
back-projects both through the rectified P_rect_02 projection and saves
the mask-intersected pairs.  The 200 calibration files default to the ones
that ship with the JAX package, read there by path.

Usage:
    python -m hplflownet_tpu_torch.data.preprocess.kitti RAW_ROOT OUT_DIR \
        [--calib_root DIR] [--workers 4]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import os.path as osp
from functools import partial

import numpy as np

from ..io import SHIPPED_DATA_DIR, read_kitti_disparity, read_kitti_flow

BASELINE = 0.54


def read_p_rect(calib_path: str) -> np.ndarray:
    with open(calib_path) as fd:
        for line in fd:
            if line.startswith("P_rect_02"):
                return np.array([float(v) for v in line.split()[1:]],
                                dtype=np.float32).reshape(3, 4)
    raise ValueError(f"no P_rect_02 in {calib_path}")


def pixel2xyz(depth: np.ndarray, p_rect: np.ndarray,
              px: np.ndarray | None = None, py: np.ndarray | None = None):
    """Back-project (px, py, depth) through the rectified pinhole model.

    Matches the reference's axis convention: x and y are negated
    (kitti_utils.py:5-27).
    """
    assert p_rect[0, 0] == p_rect[1, 1]
    focal = p_rect[0, 0]
    height, width = depth.shape[:2]
    if px is None:
        px = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    if py is None:
        py = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    const_x = p_rect[0, 2] * depth + p_rect[0, 3]
    const_y = p_rect[1, 2] * depth + p_rect[1, 3]
    x = (px * (depth + p_rect[2, 3]) - const_x) / focal
    y = (py * (depth + p_rect[2, 3]) - const_y) / focal
    pc = np.stack([-x, -y, depth], axis=-1)
    return pc.astype(np.float32)


def disp_to_depth(disp, valid, focal):
    depth = focal * BASELINE / (disp + 1e-5)
    depth[~valid] = -1.0
    return depth


def process_one_frame(idx, data_root, save_path, calib_root):
    sidx = f"{idx:06d}"
    p_rect = read_p_rect(osp.join(calib_root, sidx + ".txt"))
    focal = p_rect[0, 0]

    disp1, valid1 = read_kitti_disparity(
        osp.join(data_root, "training", "disp_occ_0", sidx + "_10.png"))
    disp2, valid2 = read_kitti_disparity(
        osp.join(data_root, "training", "disp_occ_1", sidx + "_10.png"))
    depth1 = disp_to_depth(disp1, valid1, focal)
    depth2 = disp_to_depth(disp2, valid2, focal)
    valid_disp = np.logical_and(valid1, valid2)

    flow, valid_flow = read_kitti_flow(
        osp.join(data_root, "training", "flow_occ", sidx + "_10.png"))
    height, width = flow.shape[:2]
    grid_x = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    grid_y = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    ok = np.logical_and(valid_flow, valid_disp)
    px2 = np.where(ok, grid_x + flow[..., 0], 0.0).astype(np.float32)
    py2 = np.where(ok, grid_y + flow[..., 1], 0.0).astype(np.float32)

    pc1 = pixel2xyz(depth1, p_rect)
    pc2 = pixel2xyz(depth2, p_rect, px=px2, py=py2)

    out_dir = osp.join(save_path, sidx)
    os.makedirs(out_dir, exist_ok=True)
    np.save(osp.join(out_dir, "pc1.npy"), pc1[ok])
    np.save(osp.join(out_dir, "pc2.npy"), pc2[ok])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("data_root")
    ap.add_argument("save_path")
    ap.add_argument("--calib_root",
                    default=osp.join(SHIPPED_DATA_DIR, "calib_cam_to_cam"))
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    fn = partial(process_one_frame, data_root=args.data_root,
                 save_path=args.save_path, calib_root=args.calib_root)
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        pool.map(fn, range(200))
    print("processed 200 frames")


if __name__ == "__main__":
    main()
