"""chip_smoke.py's phases, rehearsed on the CPU at a small size.

On the CPU every kernel wrapper runs its plain version, so the comparisons
are trivially equal; what this checks is the script itself: shapes, tables,
tolerances, the frozen-reference phase and the contract keys of the kernels
line, so that a chip run does not fail on a Python error.
"""

import json

import pytest

import chip_smoke

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}


@pytest.fixture
def small_cpu_smoke(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NUM_POINTS", 128)
    monkeypatch.setattr(chip_smoke, "CAPACITIES",
                        [1024, 2048, 2048, 1024, 512, 256, 128])
    return chip_smoke


def test_kernel_and_reference_phases_and_the_kernels_line(small_cpu_smoke):
    cs = small_cpu_smoke
    results = {}
    cs.phase_kernels(results)
    assert len(results["stencil"]) == 8 and len(results["reduce"]) == 4
    cs.phase_reference()
    results["launches"] = {"stencil_gather_matmul": 31, "rank_reduce": 18}
    line = json.loads(json.dumps(cs.kernels_line(results)))
    assert [k["name"] for k in line["kernels"]] == ["stencil_gather_matmul",
                                                    "rank_reduce"]
    for k in line["kernels"]:
        assert KEYS <= set(k)
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes", "operations")
        assert k["launches"] > 0
