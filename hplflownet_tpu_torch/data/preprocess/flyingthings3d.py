"""FlyingThings3D-subset preprocessing: disparity/flow -> point-cloud pairs.

The port's copy of ``hplflownet_tpu/data/preprocess/flyingthings3d.py``,
writing the same ``pc1.npy`` / ``pc2.npy`` bytes.  It reconstructs pc1 from
disparity and pc2 from (flow, disparity + disparity change) through the
fixed f=-1050, cx=479.5, cy=269.5 intrinsics and a unit baseline, masks
occlusions, and optionally keeps only points nearer than 35 m.  Frames are
processed by a pool of ``--workers`` spawned processes.

Usage:
    python -m hplflownet_tpu_torch.data.preprocess.flyingthings3d \
        --raw_data_path RAW --save_path OUT [--only_save_near_pts] [--workers 4]
"""

from __future__ import annotations

import argparse
import multiprocessing
import os
import os.path as osp
from functools import partial

import numpy as np

from ..io import read_pfm, read_flo, read_any

F, CX, CY = -1050.0, 479.5, 269.5
BASELINE = 1.0


def _pixel_grid(height, width):
    px = np.tile(np.arange(width, dtype=np.float32)[None, :], (height, 1))
    py = np.tile(np.arange(height, dtype=np.float32)[:, None], (1, width))
    return px, py


def pixel2pc(disparity: np.ndarray, flow: np.ndarray | None = None):
    """Back-project a disparity map (optionally advected by flow) to 3D."""
    height, width = disparity.shape
    depth = -F * BASELINE / disparity
    px, py = _pixel_grid(height, width)
    if flow is not None:
        px = px + flow[..., 0]
        py = py + flow[..., 1]
    x = (px - CX) * -1.0 / disparity
    y = (py - CY) * 1.0 / disparity
    return np.stack([x, y, depth], axis=-1).astype(np.float32)


def process_one_file(params, root_path, save_path, save_near=False):
    split, fname = params
    out_dir = osp.join(save_path, split, fname)
    os.makedirs(out_dir, exist_ok=True)

    disp1 = read_pfm(osp.join(root_path, split, "disparity", "left",
                              fname + ".pfm"))
    disp1_occ = read_any(osp.join(root_path, split, "disparity_occlusions",
                                  "left", fname + ".png"))
    disp1_change = read_pfm(osp.join(root_path, split, "disparity_change",
                                     "left", "into_future", fname + ".pfm"))
    flow = read_flo(osp.join(root_path, split, "flow", "left",
                             "into_future", fname + ".flo"))
    flow_occ = read_any(osp.join(root_path, split, "flow_occlusions",
                                 "left", "into_future", fname + ".png"))

    pc1 = pixel2pc(disp1)
    pc2 = pixel2pc(disp1 + disp1_change, flow=flow)

    valid = np.logical_and(np.asarray(disp1_occ) == 0,
                           np.asarray(flow_occ) == 0)
    pc1, pc2 = pc1[valid], pc2[valid]

    if save_near:
        near = np.logical_and(pc1[..., -1] > -35.0, pc2[..., -1] > -35.0)
        pc1, pc2 = pc1[near], pc2[near]

    np.save(osp.join(out_dir, "pc1.npy"), pc1)
    np.save(osp.join(out_dir, "pc2.npy"), pc2)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--raw_data_path", required=True)
    ap.add_argument("--save_path", required=True)
    ap.add_argument("--only_save_near_pts", action="store_true")
    ap.add_argument("--workers", type=int, default=4)
    args = ap.parse_args(argv)

    params = []
    for split in ("train", "val"):
        d = osp.join(args.raw_data_path, split, "disparity_change", "left",
                     "into_future")
        params.extend((split, f.split(".")[0]) for f in os.listdir(d))

    fn = partial(process_one_file, root_path=args.raw_data_path,
                 save_path=args.save_path, save_near=args.only_save_near_pts)
    with multiprocessing.get_context("spawn").Pool(args.workers) as pool:
        pool.map(fn, params)
    print(f"processed {len(params)} frame pairs")


if __name__ == "__main__":
    main()
