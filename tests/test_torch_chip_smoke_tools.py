"""chip_smoke.py's dp, bench and synthetic phases, rehearsed on the CPU.

At a small size (128 points for the flagship, 256 for the shallow model,
one bench rep), with the plain versions: the two gloo worker
interpreters against the single-process step, the gloo rank at world size
1 bit for bit, the bench's JSON line, and the synthetic tools through the
driver to the exported scenes, so that a chip run does not fail on a
Python error.  Launch counts stay 0 on the CPU.
"""

import json

import pytest
import torch

import chip_smoke


@pytest.fixture
def small_cpu_smoke(monkeypatch):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "NUM_POINTS", 128)
    # the 128-point batch's vertex counts fit (scale 0.5 needs 1025)
    monkeypatch.setattr(chip_smoke, "CAPACITIES",
                        [1024, 2048, 2048, 1280, 512, 256, 128])
    monkeypatch.setattr(chip_smoke, "SYNTH_POINTS", 256)
    monkeypatch.setattr(chip_smoke, "BENCH_REPS", 1)
    yield chip_smoke
    torch.set_num_threads(n)


def test_dp_phase(small_cpu_smoke):
    results = {}
    small_cpu_smoke.phase_dp(results)
    dp = results["dp"]
    assert dp["backend_one"] == "gloo" and len(dp["launches"]) == 2
    assert dp["gloo"]["loss_rel"] <= small_cpu_smoke.DP_LOSS_RTOL
    assert dp["gloo"]["grad_worst"] <= small_cpu_smoke.DP_GRAD_TOL
    assert all(ms > 0 for ms in dp["step_ms"]) and dp["one_rank_step_ms"] > 0


def test_bench_and_synthetic_phases(small_cpu_smoke, capsys):
    results = {}
    small_cpu_smoke.phase_bench(results)
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith('{"metric"')]
    assert len(line) == 1 and json.loads(line[0]) == results["bench"]
    assert results["bench"]["device"] == "cpu"
    small_cpu_smoke.phase_synthetic(results)
    syn = results["synthetic"]
    assert set(syn["metrics"]) == {"epe3d", "acc3ds", "acc3dr", "outliers",
                                   "epe2d", "acc2d"}
    assert syn["train_steps_per_sec"] > 0 and syn["eval_pairs_per_s"] > 0


def test_phase_order_keeps_dp_after_the_timed_tools_and_plans_last():
    import inspect
    src = inspect.getsource(chip_smoke.main)
    order = [src.index(f'("{name}"') for name in
             ("tools", "bench", "synthetic", "dp", "plans")]
    assert order == sorted(order)
