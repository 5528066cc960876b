"""The port's synthetic bench, train and eval tools on the CPU.

* ``tools.train_synthetic``: the dataset and nearest-neighbour oracle
  equal the JAX tool's; ``resample_overflowing`` passes clean pairs through,
  redraws the pairs JAX's redraws (bit for bit), and raises on impossible
  budgets (tests/test_train_synthetic.py:29-62); the CLI at a toy size.
* ``params.params_to_jax``: the port's seeded shallow model -> a JAX-layout
  pickle -> the JAX package's ``HPLFlowNetShallow.apply`` at n = 64 equals
  the port's forward within 1e-5.
* ``tools.eval_synthetic`` against the JAX tool's six metrics (frozen in
  tests/data/torch_port_eval_synth_shallow_n256.json; regenerate with
  ``python -m tests.test_torch_synthetic_tools``): the shallow model with
  seeded weights, 4 pairs of 256 points, both in bf16, so EPE3D and EPE2D
  within 1% relative and the four accuracies within 0.01 absolute.
* ``bench``: the JSON line at a toy size, and ``--measure``'s vertex counts
  at 8192 points against the numpy counter.
* slow: the full-size reproduction of training_runs/full7_eval_metrics_c.json
  from full7_params_c.pkl (flagship, 32 pairs of 8192 points, bf16 on the
  CPU; the JAX figures come from a TPU, so EPE3D and EPE2D within 2%
  relative, the accuracies within 0.02 absolute, and no overflow).
"""

import json
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu_torch import bench
from hplflownet_tpu_torch.lattice.capacity import (count_vertices_np,
                                                   synthetic_frustum_clouds)
from hplflownet_tpu_torch.models import HPLFlowNetShallow
from hplflownet_tpu_torch.params import params_from_jax, params_to_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.tools import eval_synthetic, train_synthetic
from hplflownet_tpu_torch.tools.timing import SFM5

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
from tools import train_synthetic as jax_train_synthetic  # noqa: E402

EVAL_REF = os.path.join(ROOT, "tests", "data",
                        "torch_port_eval_synth_shallow_n256.json")
EVAL_CASE = dict(arch="HPLFlowNetShallow", num_points=256, pairs=4,
                 patches=12, seed=3)
METRICS = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")
SHALLOW_CAPS = [3456, 2688, 896, 256, 128]


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree_equal(a: dict, b: dict) -> bool:
    if set(a) != set(b):
        return False
    return all(_tree_equal(a[k], b[k]) if isinstance(a[k], dict)
               else np.array_equal(np.asarray(a[k]), np.asarray(b[k])) for k in a)


def seeded_pickle(path: str) -> str:
    """EVAL_CASE's shallow model with seeded weights, as a JAX-layout pickle."""
    model = HPLFlowNetShallow(SFM5, device="cpu")
    with open(path, "wb") as fd:
        pickle.dump(seeded_jax_params(model, EVAL_CASE["seed"]), fd)
    return path


def test_dataset_and_oracle_equal_the_jax_tool():
    ours = train_synthetic.make_dataset(3, 128, seed=7, patches=12)
    theirs = jax_train_synthetic.make_dataset(3, 128, seed=7, patches=12)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    a, b, f = ours
    f = f + np.float32(0.01)        # a nonzero oracle error
    assert train_synthetic.nn_oracle_epe(a, b, f) == \
        jax_train_synthetic.nn_oracle_epe(a, b, f) > 0


def test_resample_passes_clean_pairs_through():
    spec = make_lattice_spec(SFM5, capacities=SHALLOW_CAPS)
    pc1, pc2, _ = train_synthetic.make_dataset(4, 256, seed=5, patches=12)
    keep1, keep2 = pc1.copy(), pc2.copy()
    out1, out2, flow = train_synthetic.resample_overflowing(
        spec, pc1, pc2, seed=5, patches=12, device="cpu")
    np.testing.assert_array_equal(out1, keep1)
    np.testing.assert_array_equal(out2, keep2)
    np.testing.assert_array_equal(flow, out2 - out1)


def test_resample_redraws_the_pairs_jax_redraws():
    """Capacities that some of these pairs overflow: both tools redraw the
    same pairs with the same seeds, so the sets come out equal."""
    from hplflownet_tpu.pipeline import make_lattice_spec as jax_spec
    caps = [1024, 1216, 640, 256, 128]
    pc1, pc2, _ = train_synthetic.make_dataset(4, 256, seed=11, patches=300)
    ours = train_synthetic.resample_overflowing(
        make_lattice_spec(SFM5, capacities=caps), pc1.copy(), pc2.copy(),
        seed=11, device="cpu")
    theirs = jax_train_synthetic.resample_overflowing(
        jax_spec(SFM5, capacities=caps), pc1.copy(), pc2.copy(), seed=11)
    assert not np.array_equal(ours[0], pc1), "no pair overflowed"
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


def test_resample_raises_on_impossible_budgets():
    spec = make_lattice_spec(SFM5, capacities=[128] * 5)
    pc1, pc2, _ = train_synthetic.make_dataset(1, 256, seed=3, patches=300)
    with pytest.raises(RuntimeError, match="redraws all overflow"):
        train_synthetic.resample_overflowing(spec, pc1, pc2, seed=3,
                                             patches=300, device="cpu")


def test_params_to_jax_round_trip_through_the_jax_model(tmp_path):
    """Port -> pickle -> JAX's HPLFlowNetShallow.apply at n = 64 (jitted,
    in ``exact_mode()``, as the port's kernels are window-free): within
    1e-5 of the port's float32 forward."""
    from hplflownet_tpu.models import HPLFlowNetShallow as JaxShallow
    from hplflownet_tpu.ops.dispatch import exact_mode
    from hplflownet_tpu.pipeline import flow_forward as jax_flow_forward
    from hplflownet_tpu.pipeline import make_lattice_spec as jax_spec
    model = HPLFlowNetShallow(SFM5, device="cpu")
    params_from_jax(seeded_jax_params(model, 9), model)
    path = tmp_path / "p.pkl"
    with open(path, "wb") as fd:
        pickle.dump(params_to_jax(model), fd)
    with open(path, "rb") as fd:
        tree = pickle.load(fd)
    assert _tree_equal(tree, seeded_jax_params(model, 9))

    pc1, pc2 = synthetic_frustum_clouds(1, 64, seed=4)
    caps = [768, 1024, 640, 256, 128]
    ours = flow_forward(model, make_lattice_spec(SFM5, capacities=caps),
                        pc1[0], pc2[0], adjoint_plans=False).numpy()
    jspec = jax_spec(SFM5, capacities=caps)
    with exact_mode():
        fwd = jax.jit(lambda p, a, b: jax_flow_forward(
            JaxShallow(scales_filter_map=SFM5), p, jspec, a, b,
            adjoint_plans=False))
        theirs = np.asarray(fwd(jax.tree_util.tree_map(jnp.asarray, tree),
                                jnp.asarray(pc1[0]), jnp.asarray(pc2[0])))
    assert np.isfinite(ours).all() and np.abs(theirs).max() > 0
    np.testing.assert_allclose(ours, theirs, atol=1e-5, rtol=0)


def test_train_synthetic_cli_at_a_toy_size(tmp_path):
    runs = os.path.join(ROOT, "training_runs")
    before = sorted(os.listdir(runs))
    params = tmp_path / "p.pkl"
    out = train_synthetic.main(
        ["--device", "cpu", "--num-points", "256", "--train-pairs", "2",
         "--val-pairs", "2", "--steps", "3", "--eval-every", "3",
         "--patches", "12", "--schedule", "cosine", "--warmup", "2",
         "--save-params", str(params), "--out", str(tmp_path / "curve.json")])
    assert out["overflow_total"] == 0 and out["platform"] == "cpu"
    assert [c["step"] for c in out["curve"]] == [0, 3]
    assert np.isfinite(out["final_val_epe3d"]) and out["train_steps_per_sec"] > 0
    assert json.load(open(tmp_path / "curve.json")) == out
    with open(params, "rb") as fd:
        tree = pickle.load(fd)
    model = HPLFlowNetShallow(SFM5, device="cpu")
    assert set(params_from_jax(tree)) == set(model.state_dict())
    # resuming from the pickle starts where the run ended
    again = train_synthetic.main(
        ["--device", "cpu", "--num-points", "256", "--train-pairs", "2",
         "--val-pairs", "2", "--steps", "0", "--patches", "12",
         "--init-params", str(params)])
    assert again["initial_val_epe3d"] == out["final_val_epe3d"]
    assert sorted(os.listdir(runs)) == before


def _port_eval(tmp_path):
    return eval_synthetic.main(
        ["--device", "cpu", "--params", seeded_pickle(str(tmp_path / "p.pkl")),
         "--arch", EVAL_CASE["arch"], "--num-points", str(EVAL_CASE["num_points"]),
         "--pairs", str(EVAL_CASE["pairs"]), "--patches", str(EVAL_CASE["patches"]),
         "--workdir", str(tmp_path / "work"), "--out", str(tmp_path / "m.json")])


def test_eval_synthetic_matches_the_frozen_jax_tool(tmp_path):
    ref = json.load(open(EVAL_REF))
    assert ref["case"] == EVAL_CASE
    got = _port_eval(tmp_path)
    assert json.load(open(tmp_path / "m.json")) == got
    assert got["overflowed_batches"] == 0
    for k in ("epe3d", "epe2d"):
        np.testing.assert_allclose(got[k], ref["metrics"][k], rtol=1e-2, err_msg=k)
    for k in ("acc3ds", "acc3dr", "outliers", "acc2d"):
        assert abs(got[k] - ref["metrics"][k]) <= 0.01, (k, got[k], ref["metrics"][k])
    # the dumps the visualization CLI reads
    from hplflownet_tpu_torch.data import visualization
    assert visualization.main([got["visu_dir"], "--out-dir",
                               str(tmp_path / "ply")]) == EVAL_CASE["pairs"]
    assert (tmp_path / "ply" / "0003_scene.html").exists()


def test_bench_line_at_a_toy_size():
    res = bench.run("cpu", reps=1, warmup=0, num_points=128,
                    capacities=[1024, 2048, 2048, 1024, 512, 256, 128])
    assert res["metric"] == "pairs_per_sec" and res["value"] > 0
    assert res["train_step_ms"] > 0 and res["train_pairs_per_sec"] > 0
    assert res["device"] == "cpu" and res["power_limit_w"] is None
    assert res["clock"] == "host clock"
    assert set(res["launches"]) == {"forward", "step"}
    assert set(res["launches"]["step"]) == {
        "stencil_gather_matmul", "rank_reduce", "stencil_dkernel",
        "stencil_tap_tables_sum"}


def test_bench_measure_counts_the_pairs_vertices():
    """--measure at 8192 points: the numpy counter's vertex counts (bench.py
    records 22.8k / 28.4k / 11.5k / 3.2k / 739 / 213 / 87 as the worst over
    its seeds), padded 1.15x and aligned to 256."""
    from hplflownet_tpu_torch.tools.timing import SFM7
    pc1, pc2 = synthetic_frustum_clouds(1, 8192)
    scales = [row[0] for row in SFM7]
    worst = np.maximum(count_vertices_np(pc1[0], scales),
                       count_vertices_np(pc2[0], scales))
    want = [int(-(-int(w * 1.15) // 256) * 256) for w in worst]
    assert bench.measure_capacities(SFM7, torch.from_numpy(pc1),
                                    torch.from_numpy(pc2)) == want


@pytest.mark.slow
def test_full_size_reproduction_of_the_trained_flagship(tmp_path):
    ref = json.load(open(os.path.join(ROOT, "training_runs",
                                      "full7_eval_metrics_c.json")))
    torch.set_num_threads(os.cpu_count() or 1)
    got = eval_synthetic.main(
        ["--device", "cpu", "--params",
         os.path.join(ROOT, "training_runs", "full7_params_c.pkl"),
         "--arch", "HPLFlowNet", "--num-points", "8192", "--pairs", "32",
         "--patches", "12", "--workdir", str(tmp_path)])
    misses = [(k, got[k], ref[k]) for k in ("epe3d", "epe2d")
              if not abs(got[k] - ref[k]) <= 2e-2 * abs(ref[k])]
    misses += [(k, got[k], ref[k]) for k in ("acc3ds", "acc3dr", "outliers", "acc2d")
               if not abs(got[k] - ref[k]) <= 0.02]
    assert got["overflowed_batches"] == 0 and not misses, misses


def freeze_eval_reference() -> None:
    """Run the JAX tool (tools/eval_synthetic.py) on EVAL_CASE on the CPU
    and write its six metrics to EVAL_REF."""
    import tempfile
    jax.config.update("jax_platforms", "cpu")
    from tools import eval_synthetic as jax_eval
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "m.json")
        argv = ["eval_synthetic", "--params", seeded_pickle(os.path.join(tmp, "p.pkl")),
                "--arch", EVAL_CASE["arch"], "--num-points", str(EVAL_CASE["num_points"]),
                "--pairs", str(EVAL_CASE["pairs"]), "--patches", str(EVAL_CASE["patches"]),
                "--workdir", os.path.join(tmp, "work"), "--out", out]
        saved, sys.argv = sys.argv, argv
        try:
            jax_eval.main()
        finally:
            sys.argv = saved
        metrics = json.load(open(out))
    with open(EVAL_REF, "w") as fd:
        json.dump({"case": EVAL_CASE,
                   "metrics": {k: metrics[k] for k in METRICS}}, fd, indent=1)
        fd.write("\n")
    print(f"wrote {EVAL_REF}")


if __name__ == "__main__":
    freeze_eval_reference()
