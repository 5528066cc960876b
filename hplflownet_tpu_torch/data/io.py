"""Readers/writers for the optical-flow file formats the datasets ship in,
and where the JAX package's shipped data files lie.

The port's own copy of ``hplflownet_tpu/data/io.py`` (numpy only; importing
that module would load jax).  Own implementations of the standard formats
(behavior parity with the reference's data_preprocess/IO.py readers):

* PFM   — Portable Float Map (disparity, disparity_change)
* FLO   — Middlebury .flo optical flow (magic 202021.25)
* PNG16 — KITTI uint16 PNGs (disparity x256, flow (v-2^15)/64 + valid bit)
"""

from __future__ import annotations

import os.path as osp
import re

import numpy as np

__all__ = ["read_pfm", "write_pfm", "read_flo", "write_flo",
           "read_uint16_png", "read_kitti_disparity", "read_kitti_flow",
           "read_any", "SHIPPED_DATA_DIR"]

# The KITTI scene mapping and the 200 KITTI calibration files ship with the
# JAX package; the port reads them there, by path and read-only (no import
# of that package, no second copy).
SHIPPED_DATA_DIR = osp.join(osp.dirname(osp.dirname(osp.dirname(
    osp.abspath(__file__)))), "hplflownet_tpu", "data")


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file into (H, W) or (H, W, 3) float32 (top-down rows)."""
    with open(path, "rb") as fd:
        header = fd.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file")
        dims = fd.readline()
        while dims.startswith(b"#"):
            dims = fd.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims")
        width, height = int(m.group(1)), int(m.group(2))
        scale = float(fd.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.frombuffer(fd.read(), dtype=endian + "f4")
    shape = (height, width, channels) if channels == 3 else (height, width)
    img = data.reshape(shape)
    return np.ascontiguousarray(img[::-1]).astype(np.float32)  # PFM is bottom-up


def write_pfm(path: str, image: np.ndarray, scale: float = 1.0):
    image = np.asarray(image, dtype=np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        header = b"PF"
    elif image.ndim == 2:
        header = b"Pf"
    else:
        raise ValueError("PFM needs (H, W) or (H, W, 3)")
    with open(path, "wb") as fd:
        fd.write(header + b"\n")
        fd.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        fd.write(f"{-abs(scale)}\n".encode())     # little-endian
        fd.write(np.ascontiguousarray(image[::-1]).tobytes())


_FLO_MAGIC = 202021.25


def read_flo(path: str) -> np.ndarray:
    """Read a Middlebury .flo file into (H, W, 2) float32."""
    with open(path, "rb") as fd:
        magic = np.frombuffer(fd.read(4), np.float32)[0]
        if magic != _FLO_MAGIC:
            raise ValueError(f"{path}: bad .flo magic {magic}")
        w = int(np.frombuffer(fd.read(4), np.int32)[0])
        h = int(np.frombuffer(fd.read(4), np.int32)[0])
        data = np.frombuffer(fd.read(4 * 2 * w * h), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray):
    flow = np.asarray(flow, dtype=np.float32)
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as fd:
        fd.write(np.float32(_FLO_MAGIC).tobytes())
        fd.write(np.int32(w).tobytes())
        fd.write(np.int32(h).tobytes())
        fd.write(flow.tobytes())


def read_uint16_png(path: str) -> np.ndarray:
    """uint16 PNG -> (H, W) or (H, W, C) uint16 array."""
    from PIL import Image

    img = Image.open(path)
    arr = np.asarray(img)
    if arr.dtype != np.uint16:
        arr = arr.astype(np.uint16)
    return arr


def read_kitti_disparity(path: str):
    """KITTI disp PNG: value/256, 0 = invalid -> (disp, valid)."""
    arr = read_uint16_png(path)
    valid = arr > 0
    disp = arr.astype(np.float32) / 256.0
    disp[~valid] = -1.0
    return disp, valid


def read_kitti_flow(path: str):
    """KITTI flow PNG: ((u, v) - 2^15)/64, third plane = valid bit."""
    arr = read_uint16_png(path)
    valid = arr[..., 2] == 1
    flow = (arr[..., :2].astype(np.float32) - 2.0 ** 15) / 64.0
    return flow, valid


def read_any(path: str):
    """Dispatch by extension (reference IO.read equivalent)."""
    if path.endswith(".pfm"):
        return read_pfm(path)
    if path.endswith(".flo"):
        return read_flo(path)
    if path.endswith(".png"):
        from PIL import Image

        return np.asarray(Image.open(path))
    if path.endswith(".npy"):
        return np.load(path)
    raise ValueError(f"unsupported file type: {path}")
