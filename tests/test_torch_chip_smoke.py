"""chip_smoke.py's phases, rehearsed on the CPU at a small size.

On the CPU every kernel wrapper runs its plain version, so the comparisons
are trivially equal; what this checks is the script itself: shapes, tables,
tolerances, the frozen-reference phase (forward and train step), the train
phase and the contract keys of the kernels line, so that a chip run does
not fail on a Python error.
"""

import json

import pytest

import chip_smoke

KEYS = {"name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
KERNELS = ["stencil_gather_matmul", "rank_reduce", "stencil_dkernel",
           "stencil_tap_tables_sum"]


@pytest.fixture
def small_cpu_smoke(monkeypatch):
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NUM_POINTS", 128)
    monkeypatch.setattr(chip_smoke, "CAPACITIES",
                        [1024, 2048, 2048, 1024, 512, 256, 128])
    monkeypatch.setattr(chip_smoke, "TRAIN_WARMUP", 1)
    monkeypatch.setattr(chip_smoke, "TRAIN_REPS", 1)
    return chip_smoke


def test_kernel_and_reference_phases_and_the_kernels_line(small_cpu_smoke):
    cs = small_cpu_smoke
    results = {}
    cs.phase_kernels(results)
    assert len(results["stencil"]) == 10 and len(results["reduce"]) == 6
    assert len(results["dkernel"]) == 6 and len(results["tap_tables"]) == 2
    cs.phase_reference()
    results["launches"] = dict(zip(KERNELS, (57, 25, 31, 5)))
    results["forward_launches"] = {"stencil_gather_matmul": 31, "rank_reduce": 18}
    line = json.loads(json.dumps(cs.kernels_line(results)))
    assert [k["name"] for k in line["kernels"]] == KERNELS
    for k in line["kernels"]:
        assert KEYS <= set(k)
        assert k["route"] == "cuda" and k["bound_by"] in ("bytes", "operations")
        assert k["launches"] > 0


def test_train_phase_runs_and_launches_nothing_on_the_cpu(small_cpu_smoke):
    """The whole train phase at a small size: on the CPU the wrappers run
    their plain versions, so every launch count stays 0."""
    results = {}
    small_cpu_smoke.phase_train(results)
    assert results["launches"] == dict.fromkeys(KERNELS, 0)
    assert results["train_ms"] > 0
