"""What a run takes through the cell's own files, for every cell.

At the rehearsal size on the CPU and seed 3: the weights from the entry's
``init_params`` are the reference's, tensor for tensor; the pool from the
mix's pool maker is the generator's, array for array; and the work counter
counts each known kind of product by its closed form, a new kind by its
own ``flops``, and refuses a new kind without them.
"""

import importlib
import json
import sys
import types

import numpy as np
import pytest
import torch

from flowbench import run, work
from flowbench.control import CONTROLS
from flowbench.faults import FAULTS
from flowbench.reference import model as ref_model
from flowbench.traffic import generator

from ._util import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"]: w for w in BENCH["workloads"]}
SEED = 3


@pytest.fixture
def rehearsal(monkeypatch):
    monkeypatch.setenv(run.REHEARSAL_ENV, "1")


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_weights_come_from_the_entry(cell, rehearsal):
    cfg, mix, _, device = run.cell_setup(CELLS[cell])
    entry = importlib.import_module(f"flowbench.entries.{mix['entry']}")
    got = entry.init_params(cfg, SEED, device)
    want = ref_model.init_params(cfg, SEED, device)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert entry.Session.entry == mix["entry"]


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_pool_comes_from_the_mix(cell, rehearsal):
    _, mix, _, _ = run.cell_setup(CELLS[cell])
    traffic = run.pool_maker(mix)
    assert traffic is generator
    got, want = traffic.make_pool(mix, SEED), generator.make_pool(mix, SEED)
    for a, b in zip(got, want, strict=True):
        assert len(a) == len(b) == mix["pool"]
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
    order, ref = traffic.request_order(mix, SEED), generator.request_order(mix, SEED)
    assert [next(order) for _ in range(3 * mix["pool"])] == \
        [next(ref) for _ in range(3 * mix["pool"])]


KNOWN = [{"kind": "stencil", "op": "blur", "present": 40, "taps": 15, "c_in": 6,
          "c_out": 5, "rows_in": 10, "rows_out": 9},
         {"kind": "dense", "rows": 12, "k": 7, "n": 3},
         {"kind": "splat", "entries": 44, "c": 6, "rows": 11},
         {"kind": "slice", "entries": 42, "c": 5, "rows": 11}]


def test_model_flops_counts_each_known_kind():
    closed = 2 * 40 * 6 * 5 + 2 * 12 * 7 * 3 + 2 * 44 * 6 + 2 * 42 * 5
    assert work.model_flops(KNOWN) == closed
    assert work.model_flops(KNOWN + [{"kind": "global_mean", "flops": 96}]) == closed + 96
    # a known kind is counted by its name even where it carries a count
    assert work.model_flops([dict(KNOWN[1], flops=1.0)]) == 2 * 12 * 7 * 3


def test_model_flops_refuses_a_new_kind_without_flops():
    with pytest.raises(ValueError, match="global_mean"):
        work.model_flops(KNOWN + [{"kind": "global_mean", "rows": 12}])


def test_control_and_faults_of_an_entry_without_a_row(monkeypatch):
    mod = types.ModuleType("flowbench.entries.lookup_probe")
    mod.CONTROL, mod.FAULTS = object(), {"stale": object()}
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert CONTROLS["lookup_probe"] is mod.CONTROL
    assert FAULTS["lookup_probe"] is mod.FAULTS
    assert "lookup_probe" not in CONTROLS and "lookup_probe" not in FAULTS
    assert set(CONTROLS) == set(FAULTS) == {"forward", "train"}
