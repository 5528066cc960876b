"""The check fails the control and every fault a cell can have.

At the rehearsal size on the CPU: the control (the reference one precision
down, ``flowbench.control``) in the program's place, and each fault of
``flowbench.faults`` planted under the harness, must each make a run come
out ``correct: false`` against the cell's committed limits.  The
``cuda``-marked test reads the control at each cell's own size on three
seeds on the card (``python -m pytest flowbench/tests -m cuda``).
"""

import json

import pytest
import torch

from flowbench import readings, run
from flowbench.control import CONTROLS
from flowbench.faults import FAULTS
from flowbench.traffic.generator import load_mix

from ._util import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: load_mix(w["traffic"])["entry"] for w in BENCH["workloads"]}
CASES = [(cell, "control", CONTROLS[entry]) for cell, entry in CELLS.items()]
CASES += [(cell, name, cls) for cell, entry in CELLS.items()
          for name, cls in FAULTS[entry].items()]


class _Args:
    def __init__(self, cell):
        self.workload, self.seed, self.seconds, self.trace = cell, 2**31 + 17, 0.5, 0


@pytest.mark.parametrize("cell,what,program", CASES,
                         ids=[f"{c}-{w}" for c, w, _ in CASES])
def test_check_fails(cell, what, program, monkeypatch):
    monkeypatch.setenv("FLOWBENCH_CPU_REHEARSAL", "1")
    res = run.run(_Args(cell), {"program": program})
    assert res["correct"] is False, (what, res["checks"])
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_sound_program_passes(monkeypatch):
    monkeypatch.setenv("FLOWBENCH_CPU_REHEARSAL", "1")
    res = run.run(_Args("flagship-fwd-8k"))
    assert res["correct"] is True, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_fails_on_the_card(cell, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: reads the control at the cell's own size")
    monkeypatch.delenv("FLOWBENCH_CPU_REHEARSAL", raising=False)
    limits = json.loads((ROOT / "flowbench" / "limits" / f"{cell}.json").read_text())
    bench_cell = next(w for w in BENCH["workloads"] if w["name"] == cell)
    for seed in (2100000001, 2100000002, 2100000003):
        got = readings.reading(bench_cell, seed, CONTROLS[CELLS[cell]])
        assert any(got[k] > limits[k] for k in got), (seed, got)
