"""Datasets: FlyingThings3D-subset and KITTI Scene Flow 2015.

The port's own copy of ``hplflownet_tpu/data/datasets.py`` (numpy only).
Behavior parity with the original implementation's
datasets/flyingthings3d_subset.py and datasets/kitti.py: items are dicts
of fixed-shape numpy arrays (the transforms already pad + mask).  Lattice construction is NOT done here —
it runs on device.
"""

from __future__ import annotations

import os
import os.path as osp
import warnings

import numpy as np

from .io import SHIPPED_DATA_DIR

__all__ = ["FlyingThings3DSubset", "KITTI", "DATASETS"]


class _SceneFlowDataset:
    def __init__(self, transform, num_points):
        self.transform = transform
        self.num_points = num_points
        self.samples: list[str] = []

    def __len__(self):
        return len(self.samples)

    def load(self, index, rng):
        """Fetch one item using the given RandomState (reproducible path).

        The loader derives ``rng`` from (seed, epoch, index), unlike the
        reference's racy per-worker global reseed (main.py:85-92) — two runs
        with the same seed produce identical batches regardless of thread
        scheduling.
        """
        for _ in range(10):  # resample on degenerate items (reference :41-44)
            path = self.samples[index]
            pc1, pc2 = self.pc_loader(path)
            item = self.transform((pc1, pc2), rng=rng)
            if item is not None:
                item["path"] = path
                return item
            warnings.warn(f"degenerate sample {path}, resampling")
            index = int(rng.randint(len(self.samples)))
        raise RuntimeError("10 consecutive degenerate samples")

    def __getitem__(self, index):
        return self.load(index, np.random)


class FlyingThings3DSubset(_SceneFlowDataset):
    """Processed FT3D-subset dirs with pc1.npy/pc2.npy per frame pair.

    Expects 19640 train / 3824 val leaf dirs
    (reference flyingthings3d_subset.py:69-76); every 4th sample is used
    unless ``full``.  The loader flips x and z signs (:93-99).
    """

    TRAIN_COUNT = 19640
    VAL_COUNT = 3824

    def __init__(self, train, transform, num_points, data_root,
                 full=False, strict=True):
        super().__init__(transform, num_points)
        root = osp.join(data_root, "FlyingThings3D_subset_processed_35m")
        root = osp.join(osp.realpath(osp.expanduser(root)),
                        "train" if train else "val")
        self.root = root
        self.train = train

        paths = sorted(d for d, subdirs, _ in os.walk(root) if not subdirs)
        expected = self.TRAIN_COUNT if train else self.VAL_COUNT
        if strict and len(paths) != expected:
            raise RuntimeError(
                f"expected {expected} sample dirs under {root}, found {len(paths)}")
        self.samples = paths if full else paths[::4]
        if not self.samples:
            raise RuntimeError(f"no samples under {root}")

    def pc_loader(self, path):
        pc1 = np.load(osp.join(path, "pc1.npy"))
        pc2 = np.load(osp.join(path, "pc2.npy"))
        pc1[..., 0] *= -1
        pc1[..., -1] *= -1
        pc2[..., 0] *= -1
        pc2[..., -1] *= -1
        return pc1, pc2


class KITTI(_SceneFlowDataset):
    """KITTI Scene Flow 2015, eval only (reference kitti.py:10-107).

    142 of 200 scenes are kept via the mapping file; ground is removed by the
    y < -1.4 plane on both clouds when ``remove_ground``.
    """

    def __init__(self, train, transform, num_points, data_root,
                 remove_ground=True, mapping_path=None, strict=True):
        assert train is False, "KITTI is evaluation-only"
        super().__init__(transform, num_points)
        root = osp.realpath(osp.expanduser(
            osp.join(data_root, "KITTI_processed_occ_final")))
        self.root = root
        self.remove_ground = remove_ground

        paths = [d for d, subdirs, _ in sorted(os.walk(root)) if not subdirs]
        if strict and len(paths) != 200:
            warnings.warn(f"expected 200 KITTI dirs, found {len(paths)}")

        if mapping_path is None:
            mapping_path = osp.join(SHIPPED_DATA_DIR, "KITTI_mapping.txt")
        if osp.exists(mapping_path):
            with open(mapping_path) as fd:
                lines = [ln.strip() for ln in fd.readlines()]
            paths = [p for p in paths if lines[int(osp.split(p)[-1])] != ""]
        else:
            warnings.warn(f"KITTI mapping file missing at {mapping_path}; "
                          "using all scenes")
        self.samples = paths
        if not self.samples:
            raise RuntimeError(f"no samples under {root}")

    def pc_loader(self, path):
        pc1 = np.load(osp.join(path, "pc1.npy"))
        pc2 = np.load(osp.join(path, "pc2.npy"))
        if self.remove_ground:
            is_ground = np.logical_and(pc1[:, 1] < -1.4, pc2[:, 1] < -1.4)
            keep = np.logical_not(is_ground)
            pc1, pc2 = pc1[keep], pc2[keep]
        return pc1, pc2


DATASETS = {
    "FlyingThings3DSubset": FlyingThings3DSubset,
    "KITTI": KITTI,
}
