"""The port's metrics and 2-D projections against the JAX package's.

The six evaluation metrics (EPE3D, ACC3DS, ACC3DR, Outliers3D, EPE2D,
ACC2D) are equal to JAX's on the same predictions, masked or not; the FT3D
and KITTI projections give the same 2-D flows; the port's default calib
directory is the 200 files shipped with the JAX package, read in place
(cases of tests/test_data_and_metrics.py:163-210).
"""

import os

import numpy as np
import pytest

from hplflownet_tpu.train import geometry2d as jgeo, metrics as jmet
from hplflownet_tpu_torch.train import geometry2d as tgeo, metrics as tmet


def _predictions(seed, shape, masked):
    rng = np.random.RandomState(seed)
    gt = rng.randn(*shape, 3).astype(np.float32)
    # errors across the thresholds: 0.05, 0.1, 0.3 absolute and relative
    pred = gt + rng.choice([0.01, 0.07, 0.2, 0.5], size=shape + (1,)) * \
        rng.randn(*shape, 3).astype(np.float32)
    valid = rng.rand(*shape) > 0.3 if masked else None
    return pred.astype(np.float32), gt, valid


@pytest.mark.parametrize("seed,shape,masked", [(0, (1, 64), False),
                                               (1, (2, 128), True),
                                               (2, (4, 37), True)])
def test_six_metrics_equal_jax(seed, shape, masked):
    pred, gt, valid = _predictions(seed, shape, masked)
    got3 = tmet.evaluate_3d(pred, gt, valid)
    assert got3 == jmet.evaluate_3d(pred, gt, valid)
    pc1 = gt * 3 + np.array([0, 0, 12], np.float32)
    fp, fg = tgeo.get_batch_2d_flow(pc1, pc1 + gt, pc1 + pred,
                                    ["a/FT3D/0"] * shape[0])
    got2 = tmet.evaluate_2d(fp, fg, valid)
    assert got2 == jmet.evaluate_2d(fp, fg, valid)
    assert all(np.isfinite(got3 + got2))


def test_metrics_reference_values():
    gt = np.zeros((1, 4, 3))
    gt[..., 0] = 1.0
    pred = gt.copy()
    pred[0, :3, 0] = (1.04, 1.08, 1.35)
    epe, strict, relax, outlier = tmet.evaluate_3d(pred, gt)
    np.testing.assert_allclose(epe, (0.04 + 0.08 + 0.35) / 4, atol=1e-6)
    assert (strict, relax, outlier) == (0.5, 0.75, 0.25)
    assert tmet.evaluate_2d(np.array([[[12.0, 0.0]]]),
                            np.array([[[10.0, 0.0]]])) == (2.0, 1.0)


def test_projections_equal_jax(tmp_path):
    pc = np.array([[[1.0, 2.0, 10.0], [-3.0, 0.5, 22.0]]])
    for got, want in zip(tgeo.project_3d_to_2d(pc), jgeo.project_3d_to_2d(pc)):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(tgeo.project_3d_to_2d(pc)[0][0, 0],
                               (1 * -1050.0 + 479.5 * 10) / 10)
    calib = tmp_path / "000000.txt"
    calib.write_text(
        "P_rect_02: 7.2e+02 0.0 6.0e+02 4.5e+01 0.0 7.2e+02 1.8e+02 "
        "-1.1e-01 0.0 0.0 1.0 3.0e-03\n")
    intr = tgeo.read_kitti_calib(str(calib))
    assert intr == jgeo.read_kitti_calib(str(calib))
    assert intr["f"] == np.float32(-720.0)
    args = (pc, pc + 0.1, pc + 0.12,
            ["something/KITTI_processed_occ_final/000000"])
    for got, want in zip(tgeo.get_batch_2d_flow(*args, calib_root=str(tmp_path)),
                         jgeo.get_batch_2d_flow(*args, calib_root=str(tmp_path))):
        np.testing.assert_array_equal(got, want)


def test_shipped_calib_directory_through_the_default_path():
    assert len(os.listdir(tgeo.CALIB_ROOT)) == 200
    assert tgeo.read_kitti_calib(os.path.join(tgeo.CALIB_ROOT, "000000.txt"))["f"] < 0
    rng = np.random.RandomState(0)
    pc = (rng.rand(3, 20, 3) * [10, 2, 30] + [-5, -1, 5]).astype(np.float32)
    paths = [f"x/KITTI_processed_occ_final/{i:06d}" for i in (0, 57, 199)]
    for got, want in zip(tgeo.get_batch_2d_flow(pc, pc + 0.1, pc + 0.2, paths),
                         jgeo.get_batch_2d_flow(pc, pc + 0.1, pc + 0.2, paths)):
        np.testing.assert_array_equal(got, want)
