"""chip_smoke.py's main path, large, native, lattice and op_profile phases,
rehearsed on the CPU.

At a small size (the flagship at 128 and 192 points in the large phase,
128 points elsewhere, one rep), with the plain versions, so that a chip
run does not fail on a Python error: phase 5's forward, large_cloud_bench's
rows and the per-call check, the host builder against the device builder,
the two gloo worker interpreters of the lattice-sharded forward against
the unsharded one (each rank's kernel calls replayed against their plain
versions) and the gloo rank at world size 1 bit for bit,
op_profile's forward and step.
Launch counts stay 0 on the CPU, and kernel 1's rows are checked on a card
only.
"""

import pytest
import torch

import chip_smoke


@pytest.fixture
def small_cpu_smoke(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NUM_POINTS", 128)
    monkeypatch.setattr(chip_smoke, "CAPACITIES",
                        [1024, 2048, 2048, 1280, 512, 256, 128])
    monkeypatch.setattr(chip_smoke, "LARGE_SIZES", (128, 192))
    monkeypatch.setattr(chip_smoke, "LARGE_REPS", 1)
    monkeypatch.setattr(chip_smoke, "OP_PROFILE_REPS", 1)
    yield chip_smoke
    torch.set_num_threads(n)


def test_large_and_native_phases(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_large(results)
    large = results["large"]
    assert [r["points"] for r in large["sizes"]] == [128, 192]
    for r in large["sizes"]:
        assert not any(r["overflow"].values()) and r["ms_per_pair"] > 0
    assert large["calls"]["stencil_gather_matmul"]["calls"] > 0
    assert large["calls"]["rank_reduce"]["calls"] > 0
    assert large["plain"]["points"] == 128 and large["plain"]["max_rel"] == 0.0
    small_cpu_smoke.phase_native(results)
    assert results["native"]["equal"]["corr_pc2"]
    assert results["native"]["points"] == 128


def test_main_path_phase(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_main_path(results)
    assert results["forward_launches"] == {"stencil_gather_matmul": 0,
                                           "rank_reduce": 0}
    assert results["pairs_per_s"] > 0 and results["plain_pairs_per_s"] > 0


def test_lattice_phase(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_lattice(results)
    lat = results["lattice"]
    assert lat["backend_one"] == "gloo" and len(lat["launches"]) == 2
    assert lat["max_rel"] <= small_cpu_smoke.FLOW_REL_TOL
    assert lat["flops"][0] == lat["flops"][1] > 0
    assert all(ms > 0 for ms in lat["sharded_ms"]) and lat["unsharded_ms"] > 0
    for per_call in lat["calls"]:
        assert per_call["stencil_gather_matmul"]["calls"] > 0
        assert per_call["rank_reduce"]["calls"] > 0


def test_op_profile_phase_and_the_phase_order(small_cpu_smoke):
    import inspect
    results = {}
    small_cpu_smoke.phase_op_profile(results)
    assert set(results["op_profile"]) == {"pair", "step"}
    src = inspect.getsource(chip_smoke.main)
    order = [src.index(f'("{name}"') for name in
             ("bench", "synthetic", "large", "native", "dp", "lattice",
              "op_profile", "plans")]
    assert order == sorted(order)
