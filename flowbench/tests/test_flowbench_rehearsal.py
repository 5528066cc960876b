"""The whole command, on the CPU at the rehearsal size, for every cell.

The last line is the result: the contract's keys, ``platform: cpu``, the
cell's metrics of the run's kind and nothing read from a device trace.
"""

import json

import pytest

from ._util import ROOT, last_json, run_cell

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
HOST = {"setup_s", "fwd_pairs_per_s", "fwd_p95_ms", "wall.train_pairs_per_s",
        "wall.fwd_pairs_per_s", "wall.fwd_p95_ms"}


def _metrics(cell, kind, source=None):
    return {m["name"] for m in BENCH[kind] if cell in m.get("workloads", [cell])
            and source in (None, m["source"])}


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal(cell, trace):
    r = run_cell(["--workload", cell, "--seed", "4294967311", "--seconds", "1",
                  "--trace", str(trace)], {"FLOWBENCH_CPU_REHEARSAL": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert res["device"]["platform"] == "cpu"
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
        assert f"check {name}:" in r.stderr
    kind = "per_layer" if trace else "end_to_end"
    assert set(res["metrics"]) <= _metrics(cell, kind)
    # no device metric from a CPU run: only host-clock end-to-end ones
    assert set(res["metrics"]) <= HOST
    if not trace:
        assert set(res["metrics"]) == _metrics(cell, kind, "host_clock")
        assert all(m["value"] > 0 for m in res["metrics"].values())
    else:
        assert "breakdown" not in res and "busy_s" not in res["device"]
