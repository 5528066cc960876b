"""Step-time metering for the driver, and the program's layer spans.

The port's counterpart of ``hplflownet_tpu/utils/profiling.py``.  The steps
run asynchronously on the card, so the timer synchronises the device before
it reads the clock; device traces are the driver's ``profile_dir``
(``torch.profiler``).

Spans and counters mark the port's layers for a profiler that a caller
runs (PERF.md, section 3, names each one).  They are off unless the
calling thread is inside :func:`tracing`:

* :func:`span` is then ``torch.profiler.record_function(name)``: a range
  on the profiler's own clock, the clock of its device events.  Outside
  ``tracing()`` it is one shared no-op context, so a profiler that runs
  without it sees no range of the program (with CUDA activity on, each
  range would also add a ``gpu_user_annotation`` device event);
* :func:`count` keeps a reference to a Python int or a device tensor, and
  the :class:`Counters` that ``tracing()`` yields sum them when read,
  after the caller has synchronised.  No call launches device work or
  waits for the device.

The switch is per thread: the autograd engine's device thread, which runs
a CUDA backward, opens no span.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

__all__ = ["StepTimer", "Counters", "tracing", "span", "count"]


class StepTimer:
    """Pairs/s over the steps after ``warmup``, on ``device``'s clock.

    ``first`` is the clock (``time.perf_counter``) at the end of the first
    step; ``rate`` counts the items of the steps after the ``warmup``-th,
    over the time from the end of that step to the end of the last one.
    """

    def __init__(self, warmup: int = 2, device=None):
        self.warmup = warmup
        self.device = torch.device(device) if device is not None else None
        self.count = 0
        self.items = 0
        self.first = self.start = self.end = None

    def _now(self) -> float:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()

    def step(self, n_items: int = 1):
        self.count += 1
        now = self._now()
        if self.count == 1:
            self.first = now
        if self.count == self.warmup:
            self.start = now
            self.items = 0
        elif self.count > self.warmup:
            self.items += n_items
            self.end = now

    @property
    def rate(self) -> float:
        if self.start is None or self.items == 0:
            return 0.0
        return self.items / (self.end - self.start)


class Counters(dict):
    """name -> the values :func:`count` kept, in order; :meth:`total` sums
    one name's (Python ints and 0-dim device tensors alike)."""

    def total(self, name: str):
        """The sum of ``name``'s values (0 if none): one stack-and-sum of
        its tensors.  Synchronise the device first."""
        values = self.get(name, [])
        tensors = [v for v in values if isinstance(v, torch.Tensor)]
        total = sum(v for v in values if not isinstance(v, torch.Tensor))
        if tensors:
            total += torch.stack([t.reshape(()) for t in tensors]).sum().item()
        return total


class _Switch(threading.local):
    counters = None   # the innermost open tracing()'s Counters on this thread


_switch = _Switch()
_OFF = contextlib.nullcontext()


@contextlib.contextmanager
def tracing():
    """Spans and counters on, on this thread, for the block; yields its
    :class:`Counters`.  A nested ``tracing()`` collects its own, which are
    added to the enclosing one's when it closes."""
    outer = _switch.counters
    counters = _switch.counters = Counters()
    try:
        yield counters
    finally:
        _switch.counters = outer
        if outer is not None:
            for name, values in counters.items():
                outer.setdefault(name, []).extend(values)


def span(name: str):
    """``torch.profiler.record_function(name)`` inside :func:`tracing`,
    else a shared no-op context."""
    if _switch.counters is None:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, value) -> None:
    """Keep ``value`` (an int or a device tensor, by reference) under
    ``name`` inside :func:`tracing`; else nothing."""
    counters = _switch.counters
    if counters is not None:
        counters.setdefault(name, []).append(value)
