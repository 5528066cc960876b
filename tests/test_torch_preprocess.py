"""The port's offline data CLIs against the JAX package's, on the CPU.

* ``data.preprocess.flyingthings3d`` and ``data.preprocess.kitti``: both
  packages' CLIs run (in subprocesses, with their process pools) on raw
  pfm, flo, png and calibration files this test writes; every ``pc1.npy``
  and ``pc2.npy`` of the port equals JAX's byte for byte.
* ``data.visualization``: ``write_ply``, ``export_scene`` and
  ``export_html`` write the same bytes as JAX's on the inputs of
  tests/test_io_and_port.py, and the CLI exports a ``visu_*`` directory.
"""

import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest

from hplflownet_tpu.data import visualization as jax_vis
from hplflownet_tpu_torch.data import visualization
from hplflownet_tpu_torch.data.io import SHIPPED_DATA_DIR, write_flo, write_pfm
from hplflownet_tpu_torch.data.preprocess import flyingthings3d, kitti

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W = 6, 8


def write_png16(path: str, arr: np.ndarray) -> None:
    """A 16-bit grayscale (H, W) or RGB (H, W, 3) PNG, written by hand."""
    arr = np.asarray(arr, np.uint16)
    color = 2 if arr.ndim == 3 else 0
    rows = arr.reshape(arr.shape[0], -1).astype(">u2").tobytes()
    stride = arr[0].size * 2
    raw = b"".join(b"\x00" + rows[i * stride:(i + 1) * stride]
                   for i in range(arr.shape[0]))

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", arr.shape[1], arr.shape[0], 16, color, 0, 0, 0)
    with open(path, "wb") as fd:
        fd.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                 + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_png8(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    Image.fromarray(np.asarray(arr, np.uint8)).save(path)


def make_raw_ft3d(root: str, rng) -> None:
    """Two frames a split in the raw FlyingThings3D-subset layout."""
    for split in ("train", "val"):
        for k in range(2):
            name = f"{k:07d}"
            paths = {
                "disp": ("disparity", "left", name + ".pfm"),
                "occ": ("disparity_occlusions", "left", name + ".png"),
                "change": ("disparity_change", "left", "into_future", name + ".pfm"),
                "flow": ("flow", "left", "into_future", name + ".flo"),
                "flow_occ": ("flow_occlusions", "left", "into_future", name + ".png"),
            }
            paths = {key: os.path.join(root, split, *p) for key, p in paths.items()}
            for p in paths.values():
                os.makedirs(os.path.dirname(p), exist_ok=True)
            # |disparity| 15-80 px: depths of 13-70 m either side of the
            # camera, so that the near option (z > -35 m) cuts some points
            sign = np.where(rng.rand(H, W) < 0.5, -1.0, 1.0)
            write_pfm(paths["disp"], sign * rng.uniform(15, 80, (H, W)))
            write_pfm(paths["change"], rng.uniform(-3, 3, (H, W)))
            write_flo(paths["flow"], rng.uniform(-5, 5, (H, W, 2)))
            write_png8(paths["occ"], (rng.rand(H, W) < 0.2) * 255)
            write_png8(paths["flow_occ"], (rng.rand(H, W) < 0.2) * 255)


def make_raw_kitti(root: str, rng) -> None:
    """The 200 training frames the KITTI CLI reads.

    PIL opens a 16-bit RGB PNG as 8-bit RGB (each sample's high byte), and
    both packages' ``read_kitti_flow`` read through it; so the flow files
    carry the valid bit in the high byte of the third plane (256) and the
    flow's high bytes near 2^15's, where that reader finds them."""
    for sub in ("disp_occ_0", "disp_occ_1", "flow_occ"):
        os.makedirs(os.path.join(root, "training", sub), exist_ok=True)
    for idx in range(200):
        name = f"{idx:06d}_10.png"
        for sub in ("disp_occ_0", "disp_occ_1"):
            disp = rng.randint(256 * 5, 256 * 90, (H, W))
            disp[rng.rand(H, W) < 0.2] = 0                      # invalid
            write_png16(os.path.join(root, "training", sub, name), disp)
        flow = np.stack([rng.randint(120, 136, (H, W)) << 8,
                         rng.randint(120, 136, (H, W)) << 8,
                         (rng.rand(H, W) > 0.2).astype(np.int64) << 8], axis=-1)
        write_png16(os.path.join(root, "training", "flow_occ", name), flow)


def _cli(module: str, args, cwd) -> None:
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", module, *args], capture_output=True,
                       text=True, timeout=600, env=env, cwd=cwd)
    assert r.returncode == 0, r.stderr[-3000:]


def _same_outputs(ours: str, theirs: str, expect: int) -> None:
    files = sorted(os.path.relpath(os.path.join(d, f), theirs)
                   for d, _, fs in os.walk(theirs) for f in fs)
    assert len(files) == expect
    assert files == sorted(os.path.relpath(os.path.join(d, f), ours)
                           for d, _, fs in os.walk(ours) for f in fs)
    nonempty = 0
    for f in files:
        with open(os.path.join(ours, f), "rb") as a, open(os.path.join(theirs, f), "rb") as b:
            assert a.read() == b.read(), f
        nonempty += np.load(os.path.join(ours, f)).shape[0] > 0
    assert nonempty == expect


@pytest.mark.parametrize("near", [False, True])
def test_flyingthings3d_cli_matches_jax(tmp_path, near):
    raw = tmp_path / "raw"
    make_raw_ft3d(str(raw), np.random.RandomState(0))
    flags = ["--only_save_near_pts"] if near else []
    for module, out in (("hplflownet_tpu.data.preprocess.flyingthings3d", "jax"),
                        ("hplflownet_tpu_torch.data.preprocess.flyingthings3d", "port")):
        _cli(module, ["--raw_data_path", str(raw), "--save_path",
                      str(tmp_path / out), "--workers", "2", *flags], str(tmp_path))
    _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), 8)
    far = sum(int((np.load(tmp_path / "port" / split / f"{k:07d}" / "pc1.npy")
                   [:, 2] <= -35.0).sum()) for split in ("train", "val") for k in range(2))
    assert (far == 0) == near


def test_kitti_cli_matches_jax(tmp_path):
    raw = tmp_path / "raw"
    make_raw_kitti(str(raw), np.random.RandomState(1))
    for module, out in (("hplflownet_tpu.data.preprocess.kitti", "jax"),
                        ("hplflownet_tpu_torch.data.preprocess.kitti", "port")):
        _cli(module, [str(raw), str(tmp_path / out), "--workers", "2"], str(tmp_path))
    _same_outputs(str(tmp_path / "port"), str(tmp_path / "jax"), 400)


def test_kitti_geometry_matches_jax():
    from hplflownet_tpu.data.preprocess import kitti as jax_kitti
    calib = os.path.join(SHIPPED_DATA_DIR, "calib_cam_to_cam", "000007.txt")
    p = kitti.read_p_rect(calib)
    np.testing.assert_array_equal(p, jax_kitti.read_p_rect(calib))
    rng = np.random.RandomState(2)
    disp = rng.uniform(1, 90, (H, W)).astype(np.float32)
    valid = rng.rand(H, W) > 0.3
    d1 = kitti.disp_to_depth(disp.copy(), valid, p[0, 0])
    np.testing.assert_array_equal(d1, jax_kitti.disp_to_depth(disp.copy(), valid, p[0, 0]))
    px = rng.uniform(0, W, (H, W)).astype(np.float32)
    np.testing.assert_array_equal(kitti.pixel2xyz(d1, p, px=px),
                                  jax_kitti.pixel2xyz(d1, p, px=px))
    flow = rng.uniform(-4, 4, (H, W, 2)).astype(np.float32)
    from hplflownet_tpu.data.preprocess import flyingthings3d as jax_ft3d
    np.testing.assert_array_equal(flyingthings3d.pixel2pc(disp, flow),
                                  jax_ft3d.pixel2pc(disp, flow))


def _same_dirs(a, b) -> None:
    """The files directly in ``a`` and ``b`` (not their subdirectories)."""
    names = sorted(n for n in os.listdir(a) if os.path.isfile(os.path.join(a, n)))
    assert names == sorted(n for n in os.listdir(b)
                           if os.path.isfile(os.path.join(b, n))) and names
    for n in names:
        with open(os.path.join(a, n), "rb") as x, open(os.path.join(b, n), "rb") as y:
            assert x.read() == y.read(), n


def test_ply_scene_and_html_match_jax(tmp_path):
    """tests/test_io_and_port.py's inputs through both packages."""
    pts = np.random.RandomState(0).randn(50, 3).astype(np.float32)
    for mod, out in ((visualization, "port"), (jax_vis, "jax")):
        d = tmp_path / out
        d.mkdir()
        mod.write_ply(str(d / "c.ply"), pts, np.zeros((50, 3), np.uint8))
        mod.write_ply(str(d / "plain.ply"), pts)
        mod.export_scene(str(d / "scene"), 0, pts, pts * 0.01, pts * 0.02, pts)
        rng = np.random.RandomState(3)
        p = rng.randn(64, 3).astype(np.float32)
        sf = rng.randn(64, 3).astype(np.float32) * 0.1
        flow = sf + rng.randn(64, 3).astype(np.float32) * 0.02
        mod.export_html(str(d / "scene.html"), 7, p, sf, flow, p + 1.0,
                        max_segments=16)
    _same_dirs(tmp_path / "port", tmp_path / "jax")
    _same_dirs(tmp_path / "port" / "scene", tmp_path / "jax" / "scene")
    assert len(os.listdir(tmp_path / "port" / "scene")) == 6


def test_visualization_cli_exports_a_visu_dir(tmp_path):
    rng = np.random.RandomState(4)
    visu = tmp_path / "visu_run"
    visu.mkdir()
    for i in range(2):                       # two batches of 2 and 1 pairs
        b = 2 - i
        np.save(visu / f"pc1_{i}.npy", rng.randn(b, 32, 3).astype(np.float32))
        np.save(visu / f"sf_{i}.npy", rng.randn(b, 32, 3).astype(np.float32))
        np.save(visu / f"output_{i}.npy", rng.randn(b, 32, 3).astype(np.float32))
    np.save(visu / "pc2_0.npy", rng.randn(2, 32, 3).astype(np.float32))
    assert visualization.main([str(visu)]) == 3
    out = sorted(os.listdir(visu / "ply"))
    assert "0000_pc2.ply" in out and "0002_pc2.ply" not in out
    assert "0002_scene.html" in out and len(out) == 2 * 6 + 5
