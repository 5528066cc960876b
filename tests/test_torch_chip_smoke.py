"""chip_smoke.py's phases, rehearsed on the CPU at a small size.

On the CPU every kernel wrapper runs its plain version, so the comparisons
are trivially equal; what this checks is the script itself: shapes, tables,
tolerances, the frozen-reference phase (forward and train step), the train,
fused-route, shallow-model, driver and tools phases and the contract keys
of the kernels line, so that a chip run does not fail on a Python error.
"""

import json

import pytest

import chip_smoke

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
KERNELS = ["stencil_gather_matmul", "rank_reduce", "stencil_dkernel",
           "stencil_tap_tables_sum", "blocked_rank_reduce", "row_take",
           "rank_partial", "dense_gemm", "slice_points"]
TRAIN_KERNELS = KERNELS[:4]
# what a forward and a train step launch: kernels 1-4, the dense layers'
# and the slice kernel
PATH_KERNELS = TRAIN_KERNELS + ["dense_gemm", "slice_points"]


@pytest.fixture
def small_cpu_smoke(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NUM_POINTS", 128)
    monkeypatch.setattr(chip_smoke, "CAPACITIES",
                        [1024, 2048, 2048, 1024, 512, 256, 128])
    monkeypatch.setattr(chip_smoke, "TRAIN_WARMUP", 1)
    monkeypatch.setattr(chip_smoke, "TRAIN_REPS", 1)
    monkeypatch.setattr(chip_smoke, "TOOLS_REPS", 1)
    monkeypatch.setattr(chip_smoke, "TOOLS_WIDTH_DIV", 8)
    monkeypatch.setattr(chip_smoke, "TOOLS_SORT_SIZES", (4096,))
    monkeypatch.setattr(chip_smoke, "LAB_SIZES", (1280,))
    # lattice.capacity.measured_default_capacities(128, SFM5)
    monkeypatch.setattr(chip_smoke, "SHALLOW_CAPACITIES", [768, 1024, 640, 256, 128])
    monkeypatch.setattr(chip_smoke, "DRIVER_FRAME_POINTS", 160)
    monkeypatch.setattr(chip_smoke, "DENSE_CASES", (
        ("conv2 head", 300, 64, 96, 0.1, "bfloat16"),
        ("bcn1_ conv1", 200, 64, 64, None, "bfloat16"),
        ("corr1 h1 x 15", 450, 32, 32, 0.1, "bfloat16"),
        ("conv4 head", 300, 32, 3, None, "float32")))
    monkeypatch.setattr(chip_smoke, "SLICE_CASES", (
        ("SPLATNet3D bcl3", "SPLATNet3D", 128, [640, 640, 640, 640, 256], 2),
        ("flagship-98k up0", "HPLFlowNet", 128,
         [1024, 2048, 2048, 1024, 512, 256, 128], 6),
        ("flagship-8k up6", "HPLFlowNet", 128,
         [1024, 2048, 2048, 1024, 512, 256, 128], 0)))
    return chip_smoke


def test_kernel_and_reference_phases_and_the_kernels_line(small_cpu_smoke):
    cs = small_cpu_smoke
    results = {}
    cs.phase_kernels(results)
    assert len(results["stencil"]) == 14 and len(results["reduce"]) == 8
    assert len(results["dkernel"]) == 10 and len(results["tap_tables"]) == 2
    # every stencil case reports its plan's block coverage, and the bf16
    # cases their targets against the library call
    assert all(0 < r["coverage"] <= r["coverage_natural"] <= 1
               for r in results["stencil"])
    assert [t["case"] for t in results["targets"]] == [
        c for _, c, _ in cs.TARGETS]
    # kernels 5 and 7: the path's shapes (kernel 7 at bo 8, 16 and 32) and
    # every edge case of tools.rank_cases in both dtypes; kernels 2, 5 and
    # 7 give device_ms beside ms, and kernel 5 rank_reduce's on its streams
    assert len(results["fused"]) == 6 + 9 * 2 and len(results["take"]) == 2
    assert len(results["partial"]) == 6 + 7 * 2
    assert sum(r["case"].startswith("edge ") for r in results["fused"]) == 18
    for kind in ("reduce", "fused", "partial"):
        assert all(r["device_ms"] > 0 and r["ms"] > 0 for r in results[kind])
    assert all(r["rank_reduce_device_ms"] > 0 for r in results["fused"][:6])
    # the index_add_ yardstick timed as the kernels are, on every path row
    for rows in (results["reduce"], results["fused"][:6],
                 results["partial"][:6]):
        assert all(r["library_device_ms"] > 0 for r in rows)
    # kernel 5: index_add_ and rank_reduce on 6 rows; kernel 7: index_add_
    # at each bo and output dtype, and bo 32 against bo 8 in both
    assert [(t["kernel"], t["against"]) for t in results["rank_targets"]][:-4] == (
        [("blocked_rank_reduce", "index_add_"),
         ("blocked_rank_reduce", "rank_reduce")] * 6
        + [("rank_partial", "index_add_")] * 4
        + [("rank_partial", "index_add_"), ("rank_partial", "bo=8")] * 2)
    assert all(t["met"] == (t["device_ms"] <= t["factor"] * t["yardstick_ms"])
               for t in results["rank_targets"])
    # kernels 2 and 4 at every shape of one train step (25 and 5 launches,
    # 18 of kernel 2's in the forward), on their edge cases in both dtypes,
    # and their targets (kernel 2 at the scale-2 splat twice and at the
    # bcn1_ slice adjoint, kernel 4 at corr1)
    for kind, launches, forward in (("reduce_step", 25, 18), ("tap_step", 5, 0)):
        rows = results[kind]
        assert sum(r["launches"] for r in rows) == launches
        assert sum(r["launches_forward"] for r in rows) == forward
        assert all(r["device_ms"] > 0 and r["bound_ms"] > 0 for r in rows)
        assert len({r["shape"] for r in rows}) == len(rows)
    assert {r["case"] for r in results["reduce_step"]} == {
        "step splat", "step slice adjoint"}
    assert all(r["regime"] is None for r in results["reduce_step"])  # CPU
    assert len(results["reduce_edge"]) == 10 * 2
    assert sum(r["blocked_rank_reduce_equal"]
               for r in results["reduce_edge"]) == 8 * 2
    assert len(results["tap_edge"]) == 5 * 2
    assert all(r["device_ms"] > 0 for r in results["tap_tables"]
               + results["take"])
    assert all(r["library_device_ms"] > 0 for r in results["tap_tables"]
               + results["take"])
    assert [(t["kernel"], t["against"]) for t in results["rank_targets"][-4:]] == [
        ("rank_reduce", "0.017 ms"), ("rank_reduce", "blocked_rank_reduce"),
        ("rank_reduce", "bound"), ("stencil_tap_tables_sum", "bound")]
    # the dense layers' kernel at its four cases, each timed three ways
    rows = cs.phase_dense(results)
    assert [r["case"] for r in rows] == [c[0] for c in cs.DENSE_CASES]
    assert all(r["max_abs_err"] == 0 for r in rows)          # plain on the CPU
    assert all(r["device_ms"] > 0 and r["library_device_ms"] > 0
               and r["plain_ms"] > 0 and r["bound_ms"] > 0 for r in rows)
    # the slice kernel on the calls of real forwards, timed four ways
    rows = cs.phase_slice(results)
    assert [r["case"] for r in rows] == [c[0] for c in cs.SLICE_CASES]
    assert [r["shape"].split()[2:] for r in rows] == [
        ["H=640", "C=256"], ["H=1024", "C=1024", "bias"], ["H=128", "C=128", "bias"]]
    assert all(r["device_ms"] > 0 and r["plain_device_ms"] > 0
               and r["library_device_ms"] > 0 and r["bound_by"] == "bytes"
               for r in rows)
    cs.phase_reference()
    results["launches"] = dict(zip(TRAIN_KERNELS, (57, 25, 31, 5)),
                               dense_gemm=45, slice_points=7)
    results["forward_launches"] = {"stencil_gather_matmul": 31, "rank_reduce": 18,
                                   "slice_points": 7}
    results["fused_launches"] = {"blocked_rank_reduce": 25, "rank_reduce": 0}
    results["fused_forward_launches"] = {"blocked_rank_reduce": 18,
                                         "rank_reduce": 0}
    results["tools_launches"] = {"row_take": 5, "rank_partial": 52}
    results["shallow"] = {"step_launches": dict(zip(TRAIN_KERNELS, (33, 15, 19, 3))),
                          "forward_launches": {"stencil_gather_matmul": 19,
                                               "rank_reduce": 10}}
    results["driver"] = {"train_launches": dict.fromkeys(TRAIN_KERNELS, 9),
                         "eval_launches": {"stencil_gather_matmul": 7,
                                           "rank_reduce": 7}}
    line = json.loads(json.dumps(cs.kernels_line(results)))
    assert [k["name"] for k in line["kernels"]] == KERNELS
    for k in line["kernels"]:
        assert KEYS <= set(k)
        timed = k["name"] in ("rank_reduce", "stencil_tap_tables_sum",
                              "blocked_rank_reduce", "row_take", "rank_partial",
                              "dense_gemm", "slice_points")
        assert ("device_ms" in k) == timed
        assert ("library_device_ms" in k) == timed
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes", "operations")
        assert k["launches"] > 0
        on_path = k["name"] in TRAIN_KERNELS
        for key in ("launches_shallow_step", "launches_driver_train"):
            assert (key in k) == on_path
    assert line["kernels"][0]["launches_shallow_forward"] == 19
    assert line["kernels"][1]["launches_driver_eval"] == 7


def test_train_phase_runs_and_launches_nothing_on_the_cpu(small_cpu_smoke):
    """The whole train phase at a small size: on the CPU the wrappers run
    their plain versions, so every launch count stays 0."""
    results = {}
    small_cpu_smoke.phase_train(results)
    assert results["launches"] == dict.fromkeys(PATH_KERNELS, 0)
    # every kernel call of a step replayed against its plain version, the
    # slice kernel's seven among them
    assert set(results["train_calls"]) == set(PATH_KERNELS)
    assert results["train_calls"]["slice_points"]["calls"] == \
        small_cpu_smoke.FLAGSHIP_SLICES
    assert results["train_ms"] > 0


def test_fused_and_tools_phases_run_on_the_cpu(small_cpu_smoke, monkeypatch):
    """The fused-route phase restores HPL_RANK_FUSED; the tools phase runs
    the microbench and both labs."""
    import os
    monkeypatch.setenv("HPL_RANK_FUSED", "0")
    results = {}
    small_cpu_smoke.phase_fused(results)
    assert os.environ["HPL_RANK_FUSED"] == "0"
    assert results["fused_launches"] == {"blocked_rank_reduce": 0,
                                         "rank_reduce": 0}
    assert {k: {r: len(t) for r, t in v.items()}
            for k, v in results["fused_ms"].items()} == {
        "pair": {"default": 2, "fused": 2}, "step": {"default": 2, "fused": 2}}
    small_cpu_smoke.phase_tools(results)
    assert results["tools_launches"] == {"row_take": 0, "rank_partial": 0}
    small_cpu_smoke.phase_plans(results)       # counted on a card only
    assert results["plans"]["kernels_forward"] is None
    assert [t["tool"] for t in results["tools"].values()] == [
        "microbench", "gather_lab", "rank_partial_lab"]


@pytest.fixture
def one_torch_thread():
    """Thousands of small ops: one intra-op thread keeps them from spinning
    against the other test processes' threads."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_shallow_and_driver_phases_run_on_the_cpu(small_cpu_smoke, one_torch_thread):
    """The shallow model's phase (forward, step, plain compare, frozen JAX
    reference) and the driver's (train one epoch, checkpoint, evaluate
    twice) at a small size; on the CPU nothing launches."""
    results = {}
    small_cpu_smoke.phase_shallow(results)
    sh = results["shallow"]
    assert sh["step_launches"] == dict.fromkeys(PATH_KERNELS, 0)
    assert sh["ms_pair"] > 0 and sh["ms_step"] > 0
    assert [r["against"] for r in sh["reference"]["rows"]] == ["jax", "exact"]
    small_cpu_smoke.phase_driver(results)
    dr = results["driver"]
    assert dr["train_launches"] == dict.fromkeys(PATH_KERNELS, 0)
    assert dr["train_pairs_per_s"] > 0 and dr["train_first_step_s"] > 0
    assert len(dr["eval_pairs_per_s"]) == 2 and min(dr["eval_pairs_per_s"]) > 0
    assert set(dr["metrics"]) == {"epe3d", "acc3ds", "acc3dr", "outliers",
                                  "epe2d", "acc2d"}
