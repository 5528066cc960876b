"""The port's last tools on the CPU at tiny sizes.

* ``large_cloud_bench --device cpu --sizes 256`` on the shallow model:
  zero on all four overflow counters, a finite flow, the measured
  capacities; and the tool fails when a capacity overflows.
* ``pyramid_bench`` (every stage at every scale timed) and ``op_profile
  --device cpu`` (forward and ``--train``: the top operators, families and
  groups of one call).
* ``measure_capacities`` on the ``fake_data`` FT3D-layout directory of
  tests/test_driver.py equals ``train.driver.measure_capacities_from_loader``
  on the same validation loader.
* ``port_torch_weights`` against the JAX package's
  tools/port_torch_weights.py on the reference-shaped state dict of
  tests/test_io_and_port.py (:82, :152): the same layouts and tree, loaded
  strictly into the port's HPLFlowNetShallow and saved as a checkpoint the
  driver restores; the ported model's flow equals JAX's on the same tree
  (atol 1e-3, max-rel 5e-3, tests/test_torch_shallow.py's float32 limits).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from hplflownet_tpu.lattice import build_pyramid as jax_build_pyramid
from hplflownet_tpu.models import HPLFlowNetShallow as JaxShallow
from hplflownet_tpu.pipeline import make_lattice_spec as jax_spec
from hplflownet_tpu_torch.models import HPLFlowNetShallow
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.tools import (large_cloud_bench, measure_capacities,
                                        op_profile, port_torch_weights,
                                        pyramid_bench)
from hplflownet_tpu_torch.tools.timing import SFM5
from hplflownet_tpu_torch.train.checkpoint import CheckpointIO
from hplflownet_tpu_torch.train.driver import measure_capacities_from_loader
from hplflownet_tpu_torch.train.step import create_train_state
from hplflownet_tpu_torch.utils.config import parse_args_from_yaml

try:
    from port_torch_weights import convert_weight as jax_convert_weight
    from port_torch_weights import port_state_dict as jax_port_state_dict
    from test_driver import base_config, make_fake_ft3d
    from test_io_and_port import _fake_reference_state_dict
except ImportError:          # run from the repository root
    from tests.test_driver import base_config, make_fake_ft3d
    from tests.test_io_and_port import _fake_reference_state_dict
    from tools.port_torch_weights import convert_weight as jax_convert_weight
    from tools.port_torch_weights import port_state_dict as jax_port_state_dict

SHALLOW = "HPLFlowNetShallow"


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_large_cloud_bench_on_the_cpu(capsys):
    res = large_cloud_bench.main(["--device", "cpu", "--sizes", "256", "--arch",
                                  SHALLOW, "--reps", "2", "--warmup", "1"])
    (row,) = res["sizes"]
    assert row["points"] == 256 and row["arch"] == SHALLOW
    assert row["overflow"] == dict.fromkeys(large_cloud_bench.OVERFLOW, 0)
    assert row["capacities"] == large_cloud_bench.capacities_for(256, SHALLOW)
    assert row["ms_per_pair"] > 0 and len(row["ms_reps"]) == 2
    assert row["peak_mib"] is None and row["clock"] == "host clock"
    assert row["launches"] == {"stencil_gather_matmul": 0, "rank_reduce": 0}
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and '"points": 256' in lines[0]


def test_large_cloud_bench_fails_on_overflow():
    with pytest.raises(AssertionError, match="overflow"):
        large_cloud_bench.run_size(256, "cpu", SHALLOW, reps=1, warmup=0,
                                   capacities=[128, 128, 128, 128, 128])


def test_pyramid_bench_times_every_stage():
    res = pyramid_bench.run("cpu", num_points=512, arch=SHALLOW, reps=1)
    n = len(SFM5)
    want = ({f"build_s{i}" for i in range(n)} | {f"nbtable_s{i}" for i in range(n)}
            | {f"corr_s{i}" for i in range(n)} | {f"corr_inv_s{i}" for i in range(n)}
            | {"build_pyramid"})
    assert set(res["ms"]) == want
    assert all(v > 0 for v in res["ms"].values())
    assert res["stage_ms"]["build"] == pytest.approx(
        sum(res["ms"][f"build_s{i}"] for i in range(n)))


@pytest.mark.parametrize("train", [False, True], ids=["forward", "train"])
def test_op_profile_on_the_cpu(train):
    res = op_profile.run("cpu", train=train, arch=SHALLOW, num_points=256,
                         reps=1, top=10)
    unit = "step" if train else "pair"
    assert res["busy_ms_per_" + unit] > 0 and res["kernels_per_" + unit] > 0
    assert 0 < len(res["top"]) <= 10 and len(res["families"]) <= 10
    assert res["top"][0]["ms"] >= res["top"][-1]["ms"]
    assert sum(g["share"] for g in res["groups"]) == pytest.approx(1.0)
    assert "host time" in res["clock"]
    if train:
        assert any(r["name"] == "aten::bmm" for r in res["top"])
    assert op_profile.family("void k<float, 4>(int)") == "k"
    assert op_profile.family("void (anonymous namespace)::stencil_kernel<128, "
                             "float>((anonymous namespace)::Args)") == \
        "(anonymous namespace)::stencil_kernel"
    assert op_profile.family("aten::copy_") == "aten::copy"


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools_large")
    make_fake_ft3d(str(root / "data"))
    return root


def test_measure_capacities_equals_the_driver_function(fake_data, tmp_path):
    cfg = dict(base_config(fake_data), platform="cpu")
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    caps = measure_capacities.main([str(path), "--num-batches", "2"])
    args = parse_args_from_yaml(str(path))
    want = measure_capacities_from_loader(
        cfg["scales_filter_map"], measure_capacities.val_loader(args),
        num_batches=2, slack=1.3, align=256, device="cpu")
    assert caps == want and len(caps) == len(SFM5)
    assert all(c > 0 and c % 256 == 0 for c in caps)


@pytest.mark.parametrize("shape", [(8, 5, 1), (8, 5, 15, 1), (8, 5, 1, 1),
                                   (8, 5, 1, 15, 1), (8, 5, 1, 1, 1)])
def test_convert_weight_layouts_equal_jax(shape):
    w = np.random.RandomState(0).randn(*shape).astype(np.float32)
    np.testing.assert_array_equal(port_torch_weights.convert_weight(w),
                                  jax_convert_weight(w))


def test_port_torch_weights_equals_jax_and_runs(tmp_path):
    sd = _fake_reference_state_dict()
    got, want = port_torch_weights.port_state_dict(sd), jax_port_state_dict(sd)
    assert got.keys() == want.keys() == {"params"}
    assert got["params"].keys() == want["params"].keys()
    for mod, leaves in want["params"].items():
        assert got["params"][mod].keys() == leaves.keys(), mod
        for k, v in leaves.items():
            np.testing.assert_array_equal(got["params"][mod][k], v)

    pth = tmp_path / "ours.pth.tar"
    torch.save({"epoch": 1, "state_dict": {k: torch.from_numpy(v)
                                           for k, v in sd.items()}}, pth)
    ckpt = tmp_path / "ckpt"
    model = port_torch_weights.main([str(pth), str(ckpt), "--arch", SHALLOW])
    assert {f for f in os.listdir(ckpt)} == {"checkpoint.pt", "model_best.pt"}
    template = create_train_state(HPLFlowNetShallow(SFM5, device="cpu"),
                                  device="cpu")
    state, epoch, _ = CheckpointIO(str(ckpt)).restore(template, "model_best")
    for k, p in model.named_parameters():
        assert torch.equal(state.params[k], p.detach()), k

    rng = np.random.RandomState(0)
    pc1 = rng.randn(48, 3).astype(np.float32)
    pc2 = rng.randn(48, 3).astype(np.float32)
    caps = [256, 256, 256, 128, 128]
    flow = flow_forward(model, make_lattice_spec(SFM5, caps), pc1, pc2).numpy()
    jspec = jax_spec(SFM5, capacities=caps)
    a, b = jnp.asarray(pc1), jnp.asarray(pc2)
    jflow = np.asarray(jax.jit(lambda p, x, y: JaxShallow(scales_filter_map=SFM5)
                               .apply(p, x, y, jax_build_pyramid(jspec, x, y)))(
        jax.tree_util.tree_map(jnp.asarray, want), a, b))
    assert np.isfinite(flow).all() and flow.shape == (48, 3)
    err = np.abs(flow - jflow).max()
    assert err <= 1e-3 and err / np.abs(jflow).max() <= 5e-3, err
