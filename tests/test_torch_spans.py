"""The port's layer spans and counters (``utils.profiling``), and the
benchmark's reader of them (``flowbench.layers``), on the CPU.

* Under ``torch.profiler`` inside ``tracing()``, ``flow_forward`` (both
  models) and one ``make_train_step`` step record every span of PERF.md's
  table, each inside the span it belongs to (a BCL's ``model.splat``,
  ``model.blur`` and ``model.slice`` inside its module's); without ``tracing()`` the
  same profiler sees none of them (with CUDA activity on, each range would
  add a ``gpu_user_annotation`` device event to the harness's trace).
* The flow, the loss and the updated parameters are bit for bit the same
  with tracing on and off.
* ``lattice.vertices`` is the pyramid's summed ``num_valid`` and
  ``lattice.rows`` twice its summed capacity, fused build or not.
* The switch: off outside ``tracing()`` and on other threads; a nested
  ``tracing()`` hands its counts to the enclosing one.
* ``flowbench.layers``: its attribution on a hand-made trace (main-thread
  launches up their parents, autograd-thread launches by host time,
  overlaps counted once, idle gaps by midpoint), and its profile of a
  forward and a train session at the rehearsal size (every layer named, no
  device number off the card).
* The driver's ``profile_dir`` trace carries the spans.
"""

import json
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hplflownet_tpu_torch.lattice import build_pyramid
from hplflownet_tpu_torch.models import HPLFlowNet, HPLFlowNetShallow
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.train.step import make_train_step
from hplflownet_tpu_torch.utils import profiling
from hplflownet_tpu_torch.utils.profiling import count, span, tracing

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CASES = {"HPLFlowNet": (HPLFlowNet, SFM7, [512, 512, 512, 256, 256, 128, 128]),
         "HPLFlowNetShallow": (HPLFlowNetShallow, SFM7[2:], [512, 256, 256, 128, 128])}
N = 96
PROGRAM = ("lattice.", "stencil.", "model.", "train.")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the test workers share the cores: one intra-op thread each
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(arch):
    cls, sfm, caps = CASES[arch]
    torch.manual_seed(0)
    model = cls(sfm, device="cpu")
    rng = np.random.RandomState(3)
    pc1 = torch.from_numpy(rng.randn(N, 3).astype(np.float32) * 3.0)
    pc2 = pc1 + 0.2 * torch.from_numpy(rng.randn(N, 3).astype(np.float32))
    return model, make_lattice_spec(sfm, caps), pc1, pc2


def _batch(pc1, pc2):
    ones = torch.ones((1, N), dtype=torch.bool)
    return dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                valid1=ones, valid2=ones)


def _run(arch, what):
    """-> a function of no argument that runs ``what`` once on a fresh
    case and returns its outputs (flow, or loss and parameters)."""
    model, spec, pc1, pc2 = _case(arch)
    if what == "forward":
        return lambda: flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    init, step = make_train_step(model, spec, device="cpu", on_overflow="skip")

    def train():
        state, loss = step(init(), _batch(pc1, pc2))
        return loss, state.params
    return train


def _program_events(prof):
    """(name, the nearest enclosing program span's name or None) of every
    program span the profiler recorded."""
    out = []
    for e in prof.events():
        if not e.name.startswith(PROGRAM):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith(PROGRAM):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name))
    return out


def _expected(arch, what):
    _, sfm, _ = CASES[arch]
    s = len(sfm)
    want = {("lattice.build", None)}
    for i in range(s):
        want |= {(f"lattice.scale{i}", "lattice.build"),
                 ("lattice.dedup", f"lattice.scale{i}"),
                 ("lattice.tables", f"lattice.scale{i}")}
        if i + 1 < s:
            want.add(("lattice.next", f"lattice.scale{i}"))
    want |= {("model.forward", None), ("stencil.plans", "model.forward"),
             ("model.embed", "model.forward"), ("model.head", "model.forward")}
    want |= {(f"model.{k}{i}", "model.forward") for i in range(s) for k in ("down", "up")}
    # each BCL's own stages: the encoder splats and blurs, the decoder
    # blurs and slices
    want |= {(k, f"model.down{i}") for i in range(s) for k in ("model.splat", "model.blur")}
    want |= {(k, f"model.up{i}") for i in range(s) for k in ("model.blur", "model.slice")}
    want |= {(f"model.corr{i}", "model.forward") for i in range(2, s)}
    if what == "train":
        want |= {("train.backward", None), ("train.adam", None)}
    return want


RUNS = [(arch, what) for arch in CASES for what in ("forward", "train")]


@pytest.mark.parametrize("arch,what", RUNS)
def test_spans_inside_tracing(arch, what):
    run = _run(arch, what)
    with tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert set(_program_events(prof)) == _expected(arch, what)


@pytest.mark.parametrize("arch,what", RUNS)
def test_no_span_without_tracing(arch, what):
    run = _run(arch, what)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    assert _program_events(prof) == []


@pytest.mark.parametrize("arch,what", RUNS)
def test_outputs_equal_with_tracing_on_and_off(arch, what):
    off = _run(arch, what)()
    with tracing():
        on = _run(arch, what)()
    if what == "forward":
        assert torch.equal(on, off)
    else:
        assert torch.equal(on[0], off[0])
        assert on[1].keys() == off[1].keys()
        assert all(torch.equal(on[1][k], off[1][k]) for k in off[1])


@pytest.mark.parametrize("fused", ["0", "1"])
def test_lattice_counters(fused, monkeypatch):
    monkeypatch.setenv("HPL_FUSED_BUILD", fused)
    _, spec, pc1, pc2 = _case("HPLFlowNet")
    with tracing() as counters:
        scales = build_pyramid(spec, pc1, pc2)
    assert len(counters["lattice.vertices"]) == 2 * len(scales)
    assert counters.total("lattice.vertices") == sum(
        int(sp.pc1_num_valid) + int(sp.pc2_num_valid) for sp in scales)
    assert counters.total("lattice.rows") == 2 * sum(s.capacity for s in spec.scales)
    assert 0 < counters.total("lattice.vertices") <= counters.total("lattice.rows")


def test_the_switch():
    assert span("model.forward") is span("lattice.build")   # the shared no-op
    count("x", 1)
    with tracing() as outer:
        assert isinstance(span("model.forward"), torch.profiler.record_function)
        seen = []
        worker = threading.Thread(target=lambda: seen.append(span("model.forward")))
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive() and seen[0] is profiling._OFF
        count("x", 2)
        with tracing() as inner:
            count("x", torch.tensor(3, dtype=torch.int32))
            assert inner.total("x") == 3
        assert isinstance(span("model.forward"), torch.profiler.record_function)
        count("x", torch.tensor(4))
    assert outer.total("x") == 9 and outer.total("y") == 0
    assert profiling._switch.counters is None


# --- flowbench.layers ------------------------------------------------------

def _hand_made_trace():
    """One train call: build, plans and a model module on the main thread
    (1), the backward's kernel launched from the autograd thread (2), Adam,
    a kernel outside every span, and a range's own device event; times in
    us, each kernel with its launch (CUPTI id 500 + k) and operator."""
    from flowbench.layers import Event

    def host(name, start, end, thread=1, corr=0, linked=0):
        return Event(name, False, start, end, thread, corr, linked,
                     annotation="." in name)

    spans = [host("flowbench.call0", 0, 200), host("lattice.build", 5, 40),
             host("lattice.scale0", 6, 39), host("lattice.dedup", 7, 20),
             host("model.forward", 45, 90), host("stencil.plans", 46, 50),
             host("model.down0", 55, 70), host("train.backward", 100, 150),
             host("train.adam", 160, 170)]
    ops = [host("aten::sort", 8, 10, corr=11), host("aten::cumsum", 47, 48, corr=12),
           host("aten::mm", 56, 57, corr=13), host("aten::mm", 110, 111, thread=2, corr=14),
           host("aten::_foreach_add", 161, 162, corr=15),
           host("aten::copy_", 180, 181, corr=16)]
    # (name, start, end, operator, launch time; None: no runtime event, so
    # the operator's start stands in for it)
    kernels = [("k_sort", 12, 15, 11, 9), ("k_plans", 49, 52, 12, 47.5),
               ("k_gemm", 60, 65, 13, 56.2), ("k_gemm2", 63, 66, 13, 56.5),
               ("k_back", 115, 120, 14, 110.5), ("k_adam", 165, 166, 15, None),
               ("k_copy", 182, 183, 16, 180.5)]
    events = spans + ops
    for k, (name, start, end, op, at) in enumerate(kernels):
        thread = 2 if name == "k_back" else 1
        if at is not None:
            events.append(host("cudaLaunchKernel", at, at + 0.1, thread, 500 + k, op))
        events.append(Event(name, True, start, end, thread, 500 + k, op, False))
    events.append(Event("model.forward", True, 49, 66, 1, 5, 0, True))
    return events


def test_layers_attribution_on_a_hand_made_trace():
    from flowbench.layers import _attribute
    res = _attribute(_hand_made_trace(), "train", 1, cuda=True)
    got = {k: (v["device_ms"] * 1e3, v["idle_ms"] * 1e3) for k, v in res["layers"].items()}
    want = {"lattice": (3, 34), "plans": (3, 0), "model": (6, 8), "backward": (5, 45),
            "adam": (1, 0), "unattributed": (1, 65)}
    assert got == pytest.approx(want)
    assert res["busy_ms"] * 1e3 == pytest.approx(19)
    assert res["idle_ms"] * 1e3 == pytest.approx(152)
    spans = {k: v["device_ms"] * 1e3 for k, v in res["spans"].items()}
    assert spans["lattice.build/lattice.scale0/lattice.dedup"] == pytest.approx(3)
    assert spans["model.forward/stencil.plans"] == pytest.approx(3)
    assert spans["model.forward/model.down0"] == pytest.approx(6)
    assert res["spans"]["lattice.build/lattice.scale0"]["idle_ms"] * 1e3 == pytest.approx(34)


@pytest.mark.parametrize("cell", ["shallow-fwd-8k", "flagship-train-8k"])
def test_layers_of_a_rehearsal_session(cell, monkeypatch):
    import importlib

    from flowbench import layers
    from flowbench.reference.model import init_params
    from flowbench.run import ROOT, Record, cell_setup, load_metric
    from flowbench.traffic.generator import make_pool, request_order
    monkeypatch.setenv("FLOWBENCH_CPU_REHEARSAL", "1")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = next(w for w in bench["workloads"] if w["name"] == cell)
    cfg, mix, caps, dev = cell_setup(spec)
    entry = importlib.import_module(f"flowbench.entries.{mix['entry']}")
    seed = 4294967311
    session = entry.Session(cfg, caps, mix, make_pool(mix, seed),
                            init_params(cfg, seed, dev), seed, dev)
    session.warm(request_order(mix, seed))
    out = layers.layers(session)
    assert layers.layers(session) is out       # once per session
    assert list(out["layers"]) == list(layers.LAYERS[mix["entry"]]) + ["unattributed"]
    assert all(v == {"device_ms": None, "idle_ms": None} for v in out["layers"].values())
    assert out["busy_ms"] is None and 0 < out["fill"] <= 100
    assert {"lattice.build/lattice.scale0/lattice.dedup", "model.forward/stencil.plans",
            "model.forward/model.corr2"} <= set(out["spans"])
    assert ("train.backward" in out["spans"]) == (mix["entry"] == "train")
    # the readers: one per layer of the entry, none off the card
    rec = Record(entry=mix["entry"], session=session, device=dev, spans={})
    readers = [m for m in bench["per_layer"] if m["name"].split(".")[0] in
               ("lattice", "plans", "model", "backward", "adam")
               and cell in m["workloads"] and m["source"] == "device_trace"]
    assert len(readers) == (7 if mix["entry"] == "forward" else 10)
    for m in readers:
        mod = load_metric(m["name"])
        assert mod.span(session) is out and mod.read(rec) is None
    # on a card each reader returns its own layer's number (a stand-in
    # result with a distinct number per layer and kind)
    stand_in = {"fill": 0.5, "layers": {
        layer: {"device_ms": 10.0 + i, "idle_ms": 20.0 + i}
        for i, layer in enumerate(out["layers"])}}
    session._flowbench_layers = stand_in
    card = Record(entry=mix["entry"], session=session, device=torch.device("cuda"), spans={})
    for m in readers:
        layer, kind, _ = m["name"].split(".")
        want = 0.5 if kind == "fill" else stand_in["layers"][layer][kind]
        assert load_metric(m["name"]).read(card) == want, m["name"]


def test_driver_profile_trace_carries_the_spans(tmp_path):
    from hplflownet_tpu_torch.train.driver import _start_profile, _stop_profile
    model, spec, pc1, pc2 = _case("HPLFlowNetShallow")
    init, step = make_train_step(model, spec, device="cpu")
    state = init()
    window = _start_profile(torch.device("cpu"))
    step(state, _batch(pc1, pc2))
    logged = []
    assert _stop_profile(window, str(tmp_path), SimpleNamespace(log=logged.append)) is None
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())
             ["traceEvents"]}
    assert {"lattice.build", "lattice.scale4", "model.forward", "stencil.plans",
            "train.backward", "train.adam"} <= names
    assert profiling._switch.counters is None and logged
