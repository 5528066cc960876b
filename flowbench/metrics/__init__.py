"""Metric readers, one file per metric, named as in ``BENCHMARK.json``.

``flowbench/metrics/<name>.py`` holds ``read(rec)``, which returns the
metric's value from a run's :class:`flowbench.run.Record`, or a (value,
bound) pair for a roofline share, or None where the run has nothing to
read (the harness then leaves the metric out of the line).  A per-layer
metric that times a layer on its own also has ``span(session)``, called in
a traced run after the profiled stretch while the program is alive; what
it returns is ``rec.spans[name]``.  The helpers below are shared.

Device metrics are read only from a run on a CUDA card.
"""

from __future__ import annotations

import time

import torch

from ..work import ZERO

__all__ = ["device_trace", "summed", "stretch_ms", "on_card"]


def on_card(rec_or_session) -> bool:
    return rec_or_session.device.type == "cuda"


def device_trace(rec, entry: str):
    """The run's profiled stretch, if it was on a card and of ``entry``."""
    if rec.entry != entry or rec.trace is None or not on_card(rec):
        return None
    return rec.trace


def summed(rec, fn, ks):
    """``fn(log)`` summed over the reference's logs of pool pairs ``ks``."""
    total = ZERO
    for k in ks:
        total = total + fn(rec.work[k])
    return total


def stretch_ms(fn, device, seconds: float = 1.0, min_calls: int = 3) -> float:
    """Mean host ms of back-to-back ``fn()`` calls over about ``seconds``,
    up to a synchronise at the end, after one warm-up call."""
    sync = torch.cuda.synchronize
    fn()
    sync(device)
    calls = 0
    t0 = time.perf_counter()
    while calls < min_calls or time.perf_counter() - t0 < seconds:
        fn()
        calls += 1
    sync(device)
    return (time.perf_counter() - t0) * 1e3 / calls
