"""The ``splatnet3d-seg-98k`` cell on the CPU at the rehearsal size.

A run of the cell comes out ``correct``; through ``readings.py``, the
program reads under the committed limit and the control (the reference
with float8 operands) and each fault of the segment entry over it; the
work log holds the reference's kinds and ``model_flops`` counts them by
their closed forms; and the readers of the cell's new per-layer metrics
return nothing off the card and, on a stand-in of the layers' numbers,
the self time of every span of their name and the slice's roofline share,
its result counted at the compute dtype that ``model.slice`` hands on.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from flowbench import readings, run, work
from flowbench.control import CONTROLS
from flowbench.entries import segment
from flowbench.faults import FAULTS

from ._util import ROOT, last_json, run_cell

CELL = "splatnet3d-seg-98k"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
SPEC = next(w for w in BENCH["workloads"] if w["name"] == CELL)
LIMIT = json.loads((ROOT / "flowbench" / "limits" / f"{CELL}.json").read_text())
REHEARSAL = {"FLOWBENCH_CPU_REHEARSAL": "1"}
SEED = 2**32 + 5


@pytest.fixture
def rehearsal(monkeypatch):
    monkeypatch.setenv(run.REHEARSAL_ENV, "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_the_cell_runs_correct():
    r = run_cell(["--workload", CELL, "--seed", str(SEED), "--seconds", "1",
                  "--trace", "0"], REHEARSAL)
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is True and res["failed"] == 0, res
    assert set(res["checks"]) == {"logits_rel_l2"}
    assert " forward calls in " in r.stderr


def test_control_and_faults_read_over_the_limit(rehearsal):
    assert CONTROLS["segment"] is segment.Control
    assert FAULTS["segment"] == segment.FAULTS
    assert set(segment.FAULTS) >= {"stale_logits", "half_cloud", "no_bn"}
    limit = LIMIT["logits_rel_l2"]
    assert readings.reading(SPEC, SEED, None, 2)["logits_rel_l2"] <= limit
    for program in [segment.Control, *segment.FAULTS.values()]:
        got = readings.reading(SPEC, SEED + 1, program, 2)["logits_rel_l2"]
        assert got > limit, (program.__name__, got)


def test_weights_come_from_the_reference(rehearsal):
    """The entry's weights are the reference's draw, named and shaped as
    the program's ``state_dict``."""
    from hplflownet_tpu_torch.models import SPLATNet3D

    from flowbench.reference import splatnet3d
    cfg, _, _, dev = run.cell_setup(SPEC)
    got = segment.init_params(cfg, SEED, dev)
    want = splatnet3d.init_params(cfg, SEED, dev)
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    model = SPLATNet3D(cfg["scales_filter_map"], device="cpu")
    assert {k: v.shape for k, v in model.state_dict().items()} == \
        {k: v.shape for k, v in got.items()}


def test_work_log_kinds_and_flops(rehearsal):
    cfg, mix, caps, dev = run.cell_setup(SPEC)
    traffic = run.pool_maker(mix)
    session = segment.Session(cfg, caps, mix, traffic.make_pool(mix, SEED),
                              segment.init_params(cfg, SEED, dev), SEED, dev)
    log = session.work(0)
    assert sorted({e["kind"] for e in log}) == ["batchnorm", "dense", "slice", "splat",
                                                "stencil"]
    assert [e["op"] for e in log if e["kind"] == "stencil"] == ["blur"] * 5
    n = mix["num_points"]
    bn = 4.0 * n * (cfg["embed_width"] + sum(cfg["bcl_widths"]) + cfg["head_width"])
    closed = sum(2.0 * e["present"] * e["c_in"] * e["c_out"] for e in log
                 if e["kind"] == "stencil") \
        + sum(2.0 * e["rows"] * e["k"] * e["n"] for e in log if e["kind"] == "dense") \
        + sum(2.0 * e["entries"] * e["c"] for e in log if e["kind"] in ("splat", "slice"))
    assert work.model_flops(log) == closed + bn


def test_span_readers(rehearsal):
    cfg, mix, caps, dev = run.cell_setup(SPEC)
    traffic = run.pool_maker(mix)
    session = segment.Session(cfg, caps, mix, traffic.make_pool(mix, SEED),
                              segment.init_params(cfg, SEED, dev), SEED, dev)
    session.warm(None)
    names = ("splat.device_ms.fwd", "slice.device_ms.fwd", "slice_fwd_roofline")
    mods = {name: run.load_metric(name) for name in names}
    out = mods["splat.device_ms.fwd"].span(session)
    assert all(m.span(session) is out for m in mods.values())
    paths = {p.rsplit("/", 1)[-1] for p in out["spans"]}
    assert {"model.splat", "model.blur", "model.slice"} <= paths
    rec = run.Record(entry="forward", session=session, device=dev, spans={}, work={},
                     cfg=cfg)
    assert all(m.read(rec) is None for m in mods.values())

    # a stand-in of the card's numbers: two BCLs' slices and one splat
    session._flowbench_layers = {"spans": {
        "model.forward/model.bcl1/model.slice": {"device_ms": 0.25, "idle_ms": 1.0},
        "model.forward/model.bcl2/model.slice": {"device_ms": 0.5, "idle_ms": 1.0},
        "model.forward/model.bcl1/model.splat": {"device_ms": 0.125, "idle_ms": 1.0},
        "model.forward/model.bcl1": {"device_ms": 8.0, "idle_ms": 1.0}}}
    card = run.Record(entry="forward", session=session, device=torch.device("cuda"),
                      spans={}, work={}, cfg=cfg)
    assert mods["splat.device_ms.fwd"].read(card) == 0.125
    assert mods["slice.device_ms.fwd"].read(card) == 0.75
    items = [j % mix["pool"] for j in range(run.PROFILED_CALLS["forward"])]
    w = work.ZERO
    for k in items:
        w = w + mods["slice_fwd_roofline"].slice_work(session.work(k), cfg)
    share, bound = mods["slice_fwd_roofline"].read(card)
    assert bound == "bytes"
    assert share == pytest.approx(100 * w.bytes / 3.35e12 / (0.75e-3 * len(items)))
    # an older program, without the spans: nothing to read
    session._flowbench_layers = {"spans": {"model.forward/model.bcl1": {
        "device_ms": 8.0, "idle_ms": 1.0}}}
    assert all(m.read(card) is None for m in mods.values())


def _slice_closed_form(log, s, s_result):
    """Each slice of E entries onto N points of C channels, after a splat
    of V vertices: ``(2 E C, s V C + 8 E + s_result N C)``."""
    w, v = work.ZERO, 0
    for e in log:
        if e["kind"] == "splat":
            v = e["rows"]
        elif e["kind"] == "slice":
            w = w + work.Work(2.0 * e["entries"] * e["c"],
                              s * v * e["c"] + 8 * e["entries"]
                              + s_result * e["rows"] * e["c"])
    return w


@pytest.mark.parametrize("dtype,log_of", [("bfloat16", "hand"), ("float32", "hand"),
                                          ("bfloat16", "rehearsal")])
def test_slice_work_counts_the_result_in_the_compute_dtype(rehearsal, dtype, log_of):
    """The slice's (points, C) result is charged once at the compute dtype:
    on a hand-made log, one splat of V vertices and one slice of E entries
    onto N points of C channels, the work is ``(2 E C, s V C + 8 E + s N C)``
    with s the dtype's size.  A ``model.slice`` span as long as those bytes
    take at 3.35 TB/s reads 100%; one as long as the count with the result
    in float32 reads that much less, under 100% where s is 2."""
    mod = run.load_metric("slice_fwd_roofline")
    s = work._SIZE[dtype]
    if log_of == "hand":
        v, e, n, c = 37, 211, 64, 48
        cfg = {"compute_dtype": dtype, "accumulate_dtype": "float32"}
        log = [{"kind": "splat", "entries": e, "c": c, "rows": v},
               {"kind": "slice", "entries": e, "c": c, "rows": n}]
        assert mod.slice_work(log, cfg) == work.Work(2.0 * e * c,
                                                     s * v * c + 8 * e + s * n * c)
        session = SimpleNamespace(mix={"pool": 2})
        logs = {k: log for k in range(2)}
    else:
        cfg, mix, caps, dev = run.cell_setup(SPEC)
        assert cfg["compute_dtype"] == dtype
        session = segment.Session(cfg, caps, mix, run.pool_maker(mix).make_pool(mix, SEED),
                                  segment.init_params(cfg, SEED, dev), SEED, dev)
        logs = {k: session.work(k) for k in range(mix["pool"])}
    items = [j % session.mix["pool"] for j in range(run.PROFILED_CALLS["forward"])]
    new, old = work.ZERO, work.ZERO
    for k in items:
        assert mod.slice_work(logs[k], cfg) == _slice_closed_form(logs[k], s, s)
        new = new + mod.slice_work(logs[k], cfg)
        old = old + _slice_closed_form(logs[k], s, 4)

    def share(nbytes):
        ms = nbytes / 3.35e12 * 1e3 / len(items)
        session._flowbench_layers = {"spans": {
            "model.forward/model.bcl1/model.slice": {"device_ms": ms, "idle_ms": 0.0}}}
        got, bound = mod.read(run.Record(entry="forward", session=session,
                                         device=torch.device("cuda"), spans={},
                                         work=logs, cfg=cfg))
        assert bound == "bytes"
        return got

    assert share(new.bytes) == pytest.approx(100.0, rel=1e-12)
    assert share(old.bytes) == pytest.approx(100.0 * new.bytes / old.bytes, rel=1e-12)
    assert (share(old.bytes) < 100.0) == (s < 4)


def test_the_parent_program_fails_cleanly():
    """A program without SPLATNet3D (the registry of an older port) makes
    the cell exit at once with an error, not hang."""
    probe = (
        "import sys, hplflownet_tpu_torch.models as m\n"
        "m.MODELS.pop('SPLATNet3D')\n"
        "from flowbench import run\n"
        f"sys.exit(run.main(['--workload', '{CELL}', '--seed', '1', '--seconds', '1']))\n")
    r = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, capture_output=True,
                       text=True, timeout=300, env=dict(os.environ, **REHEARSAL))
    assert r.returncode not in (0, 2, 3) and "SPLATNet3D" in r.stderr
    assert not r.stdout.strip()

