"""chip_smoke.py's main path, large, segment, native and lattice phases,
rehearsed on the CPU, and the order of the phases.

At a small size (the flagship at 128 and 192 points in the large phase,
128 points elsewhere, one rep), with the plain versions, so that a chip
run does not fail on a Python error: phase 5's forward, large_cloud_bench's
rows and the per-call check, the host builder against the device builder,
the two gloo worker interpreters of the lattice-sharded forward against
the unsharded one (each rank's kernel calls replayed against their plain
versions) and the gloo rank at world size 1 bit for bit.
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
    yield chip_smoke
    torch.set_num_threads(n)


def test_large_and_native_phases(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_large(results)
    large = results["large"]
    assert [r["points"] for r in large["sizes"]] == [128, 192]
    for r in large["sizes"]:
        assert not any(r["overflow"].values()) and r["ms_per_pair"] > 0
        assert r["launches"] == dict.fromkeys(small_cpu_smoke.FORWARD_KERNELS, 0)
    assert large["calls"]["stencil_gather_matmul"]["calls"] > 0
    # every dense product of the forward is replayed against its plain version
    assert large["calls"]["dense_gemm"]["calls"] == small_cpu_smoke.FLAGSHIP_DENSE
    assert large["calls"]["rank_reduce"]["calls"] > 0
    assert large["plain"]["points"] == 128 and large["plain"]["max_rel"] == 0.0
    small_cpu_smoke.phase_native(results)
    assert results["native"]["equal"]["corr_pc2"]
    assert results["native"]["points"] == 128


def test_segment_phase(small_cpu_smoke, monkeypatch):
    """SPLATNet3D at 4096 points, where the coarsest BCL's splat runs are
    split (``run_sums``): every kernel call replayed against its plain
    version, the split pass, K = 960 and the 256 -> 256 blurs among them,
    and the launches a card must count, there and at the full size."""
    caps = [16384, 12288, 7168, 1536, 384]
    full = small_cpu_smoke.segment_launches(small_cpu_smoke.SEG_POINTS,
                                            small_cpu_smoke.SEG_CAPACITIES)
    assert full == {"stencil_gather_matmul": 5, "rank_reduce": 8, "dense_gemm": 3}
    monkeypatch.setattr(small_cpu_smoke, "SEG_POINTS", 4096)
    monkeypatch.setattr(small_cpu_smoke, "SEG_CAPACITIES", caps)
    results = {}
    small_cpu_smoke.phase_segment(results)
    seg = results["segment"]
    assert seg["launches"] == dict.fromkeys(small_cpu_smoke.FORWARD_KERNELS, 0)
    assert small_cpu_smoke.segment_launches(4096, caps)["rank_reduce"] == 6
    assert seg["cases"] == {"rank_reduce parts": 1, "dense_gemm K=960": 1,
                            "stencil_gather_matmul 256->256": 2}
    calls = {k: v["calls"] for k, v in seg["calls"].items()}
    assert calls == {"stencil_gather_matmul": 5, "rank_reduce": 6, "dense_gemm": 3}
    assert all(0 < v <= caps[i] for i, v in enumerate(seg["vertices"]))
    assert seg["max_rel"] == 0.0 and seg["ms_per_cloud"] > 0


def test_main_path_phase(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_main_path(results)
    # what the phase counts: kernels 1 and 2 and the dense layers' kernel
    assert results["forward_launches"] == dict.fromkeys(
        small_cpu_smoke.FORWARD_KERNELS, 0)
    assert "dense_gemm" in results["forward_launches"]
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
    """The profiled phases come after the timed ones; ``tools.op_profile``
    and its phase are gone (the program's spans and the benchmark's
    ``breakdown`` replace them)."""
    import inspect
    assert not hasattr(small_cpu_smoke, "phase_op_profile")
    src = inspect.getsource(chip_smoke.main)
    assert '("op_profile"' not in src
    order = [src.index(f'("{name}"') for name in
             ("bench", "synthetic", "large", "native", "dp", "lattice",
              "plans", "fused_build")]
    assert order == sorted(order)
