"""Step-time metering for the driver.

The port's counterpart of ``hplflownet_tpu/utils/profiling.py``.  The steps
run asynchronously on the card, so the timer synchronises the device before
it reads the clock; device traces are the driver's ``profile_dir``
(``torch.profiler``).
"""

from __future__ import annotations

import time

import torch

__all__ = ["StepTimer"]


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
