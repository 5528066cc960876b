"""A profiled stretch of calls, read from ``torch.profiler`` in memory.

:func:`profile_calls` runs calls under the profiler (CPU and CUDA
activities) and keeps, from its events, every device operation (kernels,
copies, fills) with its interval, and the host's outermost operators with
theirs.  Nothing is written to disk.  :class:`Trace` then gives:

* ``busy_s``: the union of the device operations' intervals;
* ``kernel_s(names)``: the device time of the kernels whose name contains
  any of ``names`` (a per-layer metric's own list);
* ``launches``: device kernels (copies and fills left out);
* ``top_ops`` and ``idle_gaps``: the ``breakdown`` of a traced run's line:
  device time by kernel name, and the device's idle time between
  operations by the outermost host operator running at the gap's midpoint
  (``python`` where none is: the host was between operators); kernel
  names are cut to 120 characters.
"""

from __future__ import annotations

import bisect
import time
from typing import NamedTuple

import torch

__all__ = ["Trace", "profile_calls"]

_COPIES = ("Memcpy", "Memset")


class Trace(NamedTuple):
    device_ops: list      # (name, start_us, end_us)
    host_ops: list        # (name, start_us, end_us), outermost operators
    window_s: float       # host clock from the first call to the final sync
    calls: int

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in _merged(self.device_ops)) / 1e6

    @property
    def launches(self) -> int:
        return sum(1 for n, _, _ in self.device_ops if not n.startswith(_COPIES))

    def kernel_s(self, names) -> float:
        return sum(e - s for n, s, e in self.device_ops
                   if any(k in n for k in names)) / 1e6

    def top_ops(self, n: int = 10) -> list:
        by: dict = {}
        for name, s, e in self.device_ops:
            by[name] = by.get(name, 0.0) + (e - s) / 1e6
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[_short(k), v] for k, v in top]

    def idle_gaps(self, n: int = 10) -> list:
        spans = _merged(self.device_ops)
        hosts = sorted(self.host_ops, key=lambda h: h[1])
        starts = [h[1] for h in hosts]
        by: dict = {}
        for (_, end), (nxt, _) in zip(spans, spans[1:]):
            mid = (end + nxt) / 2
            i = bisect.bisect_right(starts, mid) - 1
            label = "python"
            for j in range(i, max(i - 64, -1), -1):
                if hosts[j][2] >= mid:
                    label = hosts[j][0]
                    break
            by[label] = by.get(label, 0.0) + (nxt - end) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]


def _short(name: str, width: int = 120) -> str:
    """A kernel's name without ``void`` and cut to ``width`` characters."""
    name = name[5:] if name.startswith("void ") else name
    return name if len(name) <= width else name[:width - 3] + "..."


def _merged(ops) -> list:
    out = []
    for _, s, e in sorted(ops, key=lambda o: o[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def profile_calls(call, ks, device) -> Trace:
    """``call(k)`` for each k of ``ks`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        sync()
        t0 = time.perf_counter()
        for k in ks:
            call(k)
        sync()
        window = time.perf_counter() - t0
    dev_ops, host_ops = [], []
    for evt in prof.events():
        tr = evt.time_range
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            dev_ops.append((evt.name, tr.start, tr.end))
        elif evt.cpu_parent is None and not evt.is_async:
            host_ops.append((evt.name, tr.start, tr.end))
    return Trace(dev_ops, host_ops, window, len(ks))
