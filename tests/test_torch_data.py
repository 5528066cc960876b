"""The port's data layer and config against the JAX package's, on the CPU.

For the same inputs and seeds, ``ProcessData``, ``Augmentation``, the two
datasets and ``BatchLoader`` (shuffle, drop_last, pad_last, thread counts,
epochs) give bit-identical samples and batches, padding and ``num_real``
included; ``postprocess`` gives the same config (cases of
tests/test_data_and_metrics.py).  Both packages are numpy on the host.
"""

import os
import os.path as osp

import numpy as np
import pytest
import yaml

from hplflownet_tpu.data import datasets as jds, loader as jloader, transforms as jtr
from hplflownet_tpu.utils import config as jcfg
from hplflownet_tpu_torch.data import datasets as tds, loader as tloader, transforms as ttr
from hplflownet_tpu_torch.data.io import SHIPPED_DATA_DIR
from hplflownet_tpu_torch.utils import config as tcfg

try:
    from test_driver import make_fake_ft3d
except ImportError:
    from tests.test_driver import make_fake_ft3d

DP = {"DEPTH_THRESHOLD": 35.0, "NO_CORR": True}
TOGETHER = dict(degree_range=0.17, shift_range=1.0, scale_low=0.95,
                scale_high=1.05, jitter_sigma=0.01, jitter_clip=0.0)
PC2 = dict(degree_range=0.0, shift_range=0.3, jitter_sigma=0.01,
           jitter_clip=0.0)


def clouds(n=500, seed=0):
    rng = np.random.RandomState(seed)
    pc1 = rng.rand(n, 3).astype(np.float32) * 30 + 1
    pc2 = pc1 + 0.05 * rng.randn(n, 3).astype(np.float32)
    return pc1, pc2


def assert_same(got, want):
    """Bit-identical items or batches: same keys, dtypes, shapes, values."""
    if want is None:
        assert got is None
        return
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            assert got[k] == want[k], k


# (n points, num_points, allow_less_points, NO_CORR, all beyond the depth
# threshold): tests/test_data_and_metrics.py:26-59 and their neighbours
SAMPLE_CASES = [(500, 128, False, True, False), (500, 64, False, True, True),
                (50, 128, True, True, False), (50, 128, False, True, False),
                (500, 128, False, False, False), (300, 0, False, True, False),
                (120, 128, True, False, False)]


@pytest.mark.parametrize("case", SAMPLE_CASES)
def test_process_data_matches_jax(case):
    n, num_points, allow_less, no_corr, far = case
    pc1, pc2 = clouds(n, seed=n)
    if far:
        pc1[:, 2] = 50.0
    dp = dict(DP, NO_CORR=no_corr)
    got = ttr.ProcessData(dp, num_points, allow_less)(
        (pc1, pc2), rng=np.random.RandomState(1))
    want = jtr.ProcessData(dp, num_points, allow_less)(
        (pc1, pc2), rng=np.random.RandomState(1))
    assert_same(got, want)
    if got is not None and allow_less and n < num_points:
        assert got["valid1"].sum() == n and (got["pc1"][n:] == 0).all()


@pytest.mark.parametrize("no_corr,jitter_clip,allow_less,n",
                         [(True, 0.0, False, 500), (False, 0.05, False, 500),
                          (True, 0.02, True, 90), (False, 0.0, True, 90)])
def test_augmentation_matches_jax(no_corr, jitter_clip, allow_less, n):
    pc1, pc2 = clouds(n, seed=2)
    together = dict(TOGETHER, jitter_clip=jitter_clip)
    pc2_args = dict(PC2, jitter_clip=jitter_clip)
    dp = dict(DP, NO_CORR=no_corr)
    args = (together, pc2_args, dp, 128, allow_less)
    got = ttr.Augmentation(*args)((pc1, pc2), rng=np.random.RandomState(3))
    want = jtr.Augmentation(*args)((pc1, pc2), rng=np.random.RandomState(3))
    assert_same(got, want)
    assert got["pc1"].shape == (128, 3)


@pytest.fixture(scope="module")
def ft3d_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ft3d")
    make_fake_ft3d(str(root), n_train=6, n_val=5, points=400)
    return str(root)


@pytest.mark.parametrize("train,full", [(True, True), (True, False),
                                        (False, True)])
def test_ft3d_dataset_matches_jax(ft3d_root, train, full):
    kw = dict(num_points=128, data_root=ft3d_root, full=full, strict=False)
    got = tds.FlyingThings3DSubset(train, ttr.ProcessData(DP, 128), **kw)
    want = jds.FlyingThings3DSubset(train, jtr.ProcessData(DP, 128), **kw)
    assert got.samples == want.samples and len(got) == len(want) > 0
    for i in range(len(want)):
        assert_same(got.load(i, np.random.RandomState(i)),
                    want.load(i, np.random.RandomState(i)))
    # the x/z sign flip of the loader
    raw = np.load(osp.join(got.samples[0], "pc1.npy"))
    pc1, _ = got.pc_loader(got.samples[0])
    np.testing.assert_array_equal(pc1, raw * np.array([-1, 1, -1], np.float32))
    with pytest.raises(RuntimeError, match="expected"):
        tds.FlyingThings3DSubset(train, ttr.ProcessData(DP, 128),
                                 **dict(kw, strict=True))


@pytest.mark.parametrize("remove_ground", [True, False])
def test_kitti_dataset_matches_jax(tmp_path, remove_ground):
    """Scenes whose mapping line is empty are dropped (the mapping file is
    the one shipped with the JAX package, read in place); ground points
    (y < -1.4 in both clouds) go when ``remove_ground``."""
    base = tmp_path / "KITTI_processed_occ_final"
    rng = np.random.RandomState(0)
    for i in range(6):
        d = base / f"{i:06d}"
        d.mkdir(parents=True)
        pc1 = (rng.rand(300, 3) * [20, 4, 30] - [10, 2.5, 0]).astype(np.float32)
        np.save(d / "pc1.npy", pc1)
        np.save(d / "pc2.npy", pc1 + 0.05)
    kw = dict(num_points=64, data_root=str(tmp_path),
              remove_ground=remove_ground, strict=False)
    got = tds.KITTI(False, ttr.ProcessData(DP, 64), **kw)
    want = jds.KITTI(False, jtr.ProcessData(DP, 64), **kw)
    with open(osp.join(SHIPPED_DATA_DIR, "KITTI_mapping.txt")) as fd:
        kept = [i for i, ln in enumerate(fd.read().splitlines()[:6]) if ln.strip()]
    assert [int(osp.basename(p)) for p in got.samples] == kept
    assert got.samples == want.samples
    for i in range(len(want)):
        a, b = got.pc_loader(got.samples[i]), want.pc_loader(want.samples[i])
        np.testing.assert_array_equal(a[0], b[0])
        assert (len(a[0]) < 300) == remove_ground
        assert_same(got.load(i, np.random.RandomState(i)),
                    want.load(i, np.random.RandomState(i)))


class _Toy:
    """tests/test_data_and_metrics.py's loader dataset (no ``load``)."""

    def __len__(self):
        return 6

    def __getitem__(self, i):
        return {"pc1": np.full((5, 3), i, np.float32),
                "valid1": np.ones((5,), bool), "path": f"p{i}"}


@pytest.mark.parametrize("batch_size,shuffle,drop_last,pad_last",
                         [(4, False, False, False), (4, False, False, True),
                          (4, True, None, False), (4, False, True, True),
                          (5, False, False, True), (3, True, False, True)])
def test_batch_loader_matches_jax_on_a_plain_dataset(batch_size, shuffle,
                                                     drop_last, pad_last):
    kw = dict(batch_size=batch_size, shuffle=shuffle, seed=3,
              drop_last=drop_last, pad_last=pad_last)
    got_loader = tloader.BatchLoader(_Toy(), **kw)
    want_loader = jloader.BatchLoader(_Toy(), **kw)
    assert len(got_loader) == len(want_loader)
    for _ in range(2):
        got, want = list(got_loader), list(want_loader)
        assert len(got) == len(want) == len(got_loader)
        for g, w in zip(got, want):
            assert_same(g, w)


def test_padded_batch_repeats_the_last_sample_with_false_masks():
    got = list(tloader.BatchLoader(_Toy(), batch_size=4, pad_last=True))[1]
    assert got["num_real"] == 2 and got["path"] == ["p4", "p5", "p5", "p5"]
    np.testing.assert_array_equal(got["pc1"][2], got["pc1"][1])
    assert got["valid1"][:2].all() and not got["valid1"][2:].any()
    items = [_Toy()[i] for i in (4, 5)]
    stacked = tloader._stack(items)
    assert_same(tloader._pad_batch(stacked, 4), jloader._pad_batch(stacked, 4))


@pytest.mark.parametrize("num_threads", [1, 4])
def test_batch_loader_matches_jax_on_ft3d_with_augmentation(ft3d_root,
                                                            num_threads):
    """Per-sample seeded RNG: the same batches as JAX for the same seed,
    whatever the thread count, and new draws each epoch."""
    def make(mod_ds, mod_tr, mod_loader, train):
        tr = (mod_tr.Augmentation(TOGETHER, PC2, DP, 64) if train
              else mod_tr.ProcessData(DP, 64))
        ds = mod_ds.FlyingThings3DSubset(train, tr, num_points=64,
                                         data_root=ft3d_root, full=True,
                                         strict=False)
        return mod_loader.BatchLoader(ds, 4, shuffle=train, seed=7,
                                      num_threads=num_threads,
                                      drop_last=None if train else False,
                                      pad_last=not train)
    for train in (True, False):
        got_loader = make(tds, ttr, tloader, train)
        want_loader = make(jds, jtr, jloader, train)
        epochs = []
        for _ in range(2):
            got, want = list(got_loader), list(want_loader)
            assert len(got) == len(want) == (1 if train else 2)
            for g, w in zip(got, want):
                assert_same(g, w)
            epochs.append(got)
        if train:
            assert (epochs[0][0]["pc1"] != epochs[1][0]["pc1"]).any()
        else:
            assert epochs[0][-1]["num_real"] == 1


def test_driver_val_loader_draws_what_the_jax_driver_evaluates(ft3d_root):
    """The JAX driver draws one val batch for its init probe
    (hplflownet_tpu/train/driver.py:124) before it evaluates, so it
    evaluates with the loader's second epoch; the port's driver starts its
    val loader there (``epoch=1``) and draws the same points.  The frames
    hold more points than are sampled, so each epoch draws others."""
    import logging
    from hplflownet_tpu_torch.train.driver import build_everything

    class Quiet:
        def log(self, msg):
            logging.getLogger(__name__).debug(msg)

    cfg = tcfg.postprocess(tcfg.Config(dict(
        arch="HPLFlowNetShallow", dataset="FlyingThings3DSubset",
        data_root=ft3d_root, full=True, strict=False, evaluate=True,
        resume=True, num_points=64, batch_size=2, data_process=DP,
        allow_less_points=True, workers=2, platform="cpu",
        scales_filter_map=[[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1],
                           [0.125, 1, 1, 1], [0.0625, 1, 1, 1]],
        lattice_capacities=[512, 512, 512, 256, 256])))
    got = list(build_everything(cfg, Quiet(), device="cpu")["val_loader"])
    ds = jds.FlyingThings3DSubset(False, jtr.ProcessData(DP, 64, True),
                                  num_points=64, data_root=ft3d_root,
                                  full=True, strict=False)
    jax_val = jloader.BatchLoader(ds, 2, shuffle=False, num_threads=2,
                                  drop_last=False, pad_last=True)
    first = list(jax_val)                  # the probe's epoch
    want = list(jax_val)                   # the epoch JAX evaluates
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert_same(g, w)
    assert (first[0]["pc1"] != got[0]["pc1"]).any()


RAW = """
arch: HPLFlowNet
dataset: FlyingThings3DSubset
data_root: /tmp/data
evaluate: False
custom_lr: True
lrs: "0.0001,7e-5,4.9e-5"
lr_switch_epochs: "0,110,220"
num_points: 8192
"""


def test_config_postprocess_matches_jax(tmp_path):
    raw = yaml.safe_load(RAW)
    got = tcfg.postprocess(tcfg.Config(raw))
    want = jcfg.postprocess(jcfg.Config(raw))
    assert dict(got) == dict(want)
    assert got.lr == 1e-4 and got.lrs == [1e-4, 7e-5, 4.9e-5]
    assert got.batch_size == 1 and got.dim == 3 and "device" not in got
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(dict(raw, platform="cpu",
                                        matmul_precision="highest")))
    parsed = tcfg.parse_args_from_yaml(str(path))
    assert parsed.device == "cpu" and parsed.matmul_precision == "highest"
    for bad in (dict(raw, arch="NoSuchNet"), dict(raw, evaluate=True),
                dict(raw, init="lecun"), dict(raw, lr_switch_epochs="0,0,5")):
        with pytest.raises(AssertionError):
            jcfg.postprocess(jcfg.Config(bad))
        with pytest.raises(ValueError):
            tcfg.postprocess(tcfg.Config(bad))


def test_shipped_data_dir_is_the_jax_packages():
    import hplflownet_tpu.data as jdata
    assert osp.samefile(SHIPPED_DATA_DIR, osp.dirname(jdata.__file__))
    assert len(os.listdir(osp.join(SHIPPED_DATA_DIR, "calib_cam_to_cam"))) == 200
