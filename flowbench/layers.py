"""Per-layer device and idle time, read from the program's own spans.

The program marks its layers with ``torch.profiler.record_function``
ranges and counts the lattice's fill, but only inside
``hplflownet_tpu_torch.utils.profiling.tracing()`` (PERF.md, section 3).
:func:`layers` profiles ``PROFILED_CALLS`` more calls of a session, on pool
items 0, 1, ..., under ``tracing()`` and ``torch.profiler`` (CPU and CUDA
activities, in memory), each call in its own ``flowbench.call<j>`` range.
It runs once per session (memoised on it), from the ``span(session)`` of
the per-layer metrics that read it, after the harness's own profiled
stretch, which runs with tracing off.

* Device time: each device operation (the ranges' own device events,
  ``gpu_user_annotation``, left out: they span a range's first to last
  kernel, gaps included) goes to the innermost program span of the calling
  thread open at its launch's host time: the runtime call that shares its
  CUPTI correlation id, else the host operator it links to
  (``linked_correlation_id``).  On the calling thread that is the span that
  launched it; a launch from the autograd engine's thread goes to the span
  the calling thread waits in (``train.backward``).  An operation counts
  only its time not covered by an earlier one, so the layers and
  ``unattributed`` add up to the union of the device intervals (busy).
* Idle time: each gap between the merged device intervals goes to the
  innermost span of the calling thread open at its midpoint, else to
  ``unattributed`` (a ``flowbench.call<j>`` range is no program span).
* A span belongs to the layer of its nearest enclosing layer span
  (``LAYER_SPANS``): ``stencil.plans`` is its own layer inside
  ``model.forward``.
* Fill: the program's ``lattice.vertices`` over ``lattice.rows``, in %.

The events are the profiler's raw ``KinetoEvent`` list: its parsed
``FunctionEvent`` has no ``linked_correlation_id`` in every torch version.
Where the program has no ``tracing()`` (an older program), :func:`layers`
profiles nothing and returns None; off the card it returns the layer names
with no device numbers.  On the card it logs every span path's device and
idle ms a call to standard error.
"""

from __future__ import annotations

import bisect
import sys
import time
from typing import NamedTuple

import torch

from .metrics import on_card
from .run import PROFILED_CALLS
from .trace import _merged

__all__ = ["LAYER_SPANS", "LAYERS", "UNATTRIBUTED", "Event", "layers", "value"]

LAYER_SPANS = {"lattice.build": "lattice", "stencil.plans": "plans",
               "model.forward": "model", "train.backward": "backward",
               "train.adam": "adam"}
LAYERS = {"forward": ("lattice", "plans", "model"),
          "train": ("lattice", "plans", "model", "backward", "adam")}
UNATTRIBUTED = "unattributed"
_PROGRAM = ("lattice.", "stencil.", "model.", "train.")
_MEMO = "_flowbench_layers"


def layers(session) -> dict | None:
    """The session's per-layer numbers (memoised); None where the program
    has no spans."""
    if not hasattr(session, _MEMO):
        setattr(session, _MEMO, _profile(session))
    return getattr(session, _MEMO)


def value(rec, entry: str, *path):
    """``layers(...)[path[0]][path[1]]...`` of a run on the card with
    ``entry``, else None."""
    got = getattr(rec.session, _MEMO, None)
    if rec.entry != entry or got is None or not on_card(rec):
        return None
    for key in path:
        got = got[key]
    return got


def _profile(session) -> dict | None:
    try:
        from hplflownet_tpu_torch.utils.profiling import tracing
    except ImportError:
        return None
    from torch.profiler import ProfilerActivity, profile, record_function
    cuda = on_card(session)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    n = PROFILED_CALLS[session.entry]
    pool = int(session.mix["pool"])
    with tracing() as counters, profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for j in range(n):
            with record_function(f"flowbench.call{j}"):
                session.call(j % pool)
        sync()
        wall_s = time.perf_counter() - t0
    rows = counters.total("lattice.rows")
    out = {"calls": n, "wall_ms": 1e3 * wall_s / n,
           "fill": 100.0 * counters.total("lattice.vertices") / rows if rows else None}
    out.update(_attribute(_events(prof), session.entry, n, cuda))
    if cuda:
        _log(out)
    return out


class Event(NamedTuple):
    """One profiler event (``torch.profiler``'s raw ``KinetoEvent``)."""
    name: str
    device: bool          # a device operation (or a range's device event)
    start: float          # us from the trace's start
    end: float
    thread: int
    corr: int             # a device operation's and its launch's: CUPTI's
    linked: int           # the launching host operator's ``corr`` (0: none)
    annotation: bool      # a ``record_function`` range


def _events(prof) -> list:
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cuda = torch.autograd.DeviceType.CUDA
    return [Event(k.name(), k.device_type() == cuda, (k.start_ns() - t0) / 1e3,
                  (k.end_ns() - t0) / 1e3, k.start_thread_id(), k.correlation_id(),
                  k.linked_correlation_id(), k.is_user_annotation())
            for k in res.events()]


def _attribute(events, entry: str, n: int, cuda: bool) -> dict:
    """Device and idle ms a call per layer and per span path."""
    calls = [e for e in events if e.name.startswith("flowbench.call") and not e.device]
    main = calls[0].thread if calls else None
    spans = sorted((e for e in events if e.name.startswith(_PROGRAM) and not e.device
                    and e.thread == main), key=lambda e: (e.start, -e.end))
    parent, stack = [], []
    for i, e in enumerate(spans):
        while stack and not (spans[stack[-1]].start <= e.start and e.end <= spans[stack[-1]].end):
            stack.pop()
        parent.append(stack[-1] if stack else None)
        stack.append(i)
    paths = [_path(i, spans, parent) for i in range(len(spans))]
    layer_of = [_layer(i, spans, parent) for i in range(len(spans))]
    names = LAYERS[entry] + (UNATTRIBUTED,)
    res = {"layers": {k: {"device_ms": None, "idle_ms": None} for k in names},
           "busy_ms": None, "idle_ms": None,
           "spans": {p: {"device_ms": None, "idle_ms": None} for p in sorted(set(paths))}}
    if not cuda:
        return res
    starts = [e.start for e in spans]

    def innermost(t):
        """The innermost span of the calling thread open at host time t."""
        i = bisect.bisect_right(starts, t) - 1
        i = None if i < 0 else i
        while i is not None and spans[i].end < t:
            i = parent[i]
        return i

    launches, ops = {}, {}
    for e in events:
        if not e.device:
            if e.linked:
                launches[e.corr] = e          # runtime calls, by CUPTI's id
            else:
                ops.setdefault(e.corr, e)
    device = sorted((e for e in events if e.device and not e.annotation),
                    key=lambda e: e.start)
    dev_ms = dict.fromkeys(names, 0.0)
    idle_ms = dict.fromkeys(names, 0.0)
    span_dev = dict.fromkeys(res["spans"], 0.0)
    span_idle = dict.fromkeys(res["spans"], 0.0)

    def charge(i, ms, by_layer, by_span):
        by_layer[UNATTRIBUTED if i is None else layer_of[i]] += ms
        if i is not None:
            by_span[paths[i]] += ms

    covered = float("-inf")
    for e in device:
        ms = max(0.0, e.end - max(e.start, covered)) / 1e3
        covered = max(covered, e.end)
        launch = launches.get(e.corr) or ops.get(e.linked)
        charge(None if launch is None else innermost(launch.start), ms, dev_ms, span_dev)
    merged = _merged([(None, e.start, e.end) for e in device])
    gaps = [(end, nxt) for (_, end), (nxt, _) in zip(merged, merged[1:])]
    for end, nxt in gaps:
        charge(innermost((end + nxt) / 2), (nxt - end) / 1e3, idle_ms, span_idle)
    for k in names:
        res["layers"][k] = {"device_ms": dev_ms[k] / n, "idle_ms": idle_ms[k] / n}
    for p in res["spans"]:
        res["spans"][p] = {"device_ms": span_dev[p] / n, "idle_ms": span_idle[p] / n}
    res["busy_ms"] = sum(e - s for s, e in merged) / 1e3 / n
    res["idle_ms"] = sum(nxt - end for end, nxt in gaps) / 1e3 / n
    return res


def _path(i, spans, parent) -> str:
    names = []
    while i is not None:
        names.append(spans[i].name)
        i = parent[i]
    return "/".join(reversed(names))


def _layer(i, spans, parent) -> str:
    while i is not None and spans[i].name not in LAYER_SPANS:
        i = parent[i]
    return UNATTRIBUTED if i is None else LAYER_SPANS[spans[i].name]


def _log(out: dict) -> None:
    say = lambda msg: print(f"[flowbench] {msg}", file=sys.stderr, flush=True)  # noqa: E731
    say(f"layers over {out['calls']} traced calls: {out['busy_ms']:.4f} ms busy, "
        f"{out['idle_ms']:.4f} ms idle, {out['wall_ms']:.4f} ms wall a call; "
        f"fill {out['fill']}%")
    for k, v in out["layers"].items():
        say(f"layer {k}: device {v['device_ms']:.4f} ms, idle {v['idle_ms']:.4f} ms a call")
    for p, v in out["spans"].items():
        say(f"span {p}: device {v['device_ms']:.4f} ms, idle {v['idle_ms']:.4f} ms a call (self)")
