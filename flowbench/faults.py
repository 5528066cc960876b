"""Faults planted in the program under the harness, for the check's tests.

Each is the measured program's entry with one thing broken where it is
produced; a run of a cell with any of them must come out ``correct:
false``.  The tests (``flowbench/tests``) and ``flowbench/readings.py`` use
them; the benchmark's runs never do.

* ``unchanged`` (train): the step returns its state unchanged;
* ``half_batch`` (train): half of the sample's points are left out and the
  loss is the mean over the rest;
* ``stale_loss`` (train): the step reports the previous step's loss;
* ``stale_flow`` (forward): a request gets the previous request's flow;
* ``half_cloud`` (forward): half of cloud 1's points are left out.

One card, so no fault leaves out an exchange between cards.  An entry with
no row in ``FAULTS`` brings its own, ``flowbench.entries.<entry>.FAULTS``.
"""

from __future__ import annotations

import numpy as np

from .entries import ByEntry, forward, train

__all__ = ["FAULTS"]


class Unchanged(train.Program):
    def __call__(self, batch):
        old = self.state
        loss, overflow = super().__call__(batch)
        self.state = old
        return loss, overflow


class HalfBatch(train.Program):
    def __call__(self, batch):
        valid = batch["valid1"].copy()
        valid[:, valid.shape[1] // 2:] = False
        return super().__call__(dict(batch, valid1=valid))


class StaleLoss(train.Program):
    last = 0.0

    def __call__(self, batch):
        loss, overflow = super().__call__(batch)
        stale, self.last = self.last, loss
        return stale, overflow


class StaleFlow(forward.Program):
    last = None

    def __call__(self, pc1, pc2):
        flow = super().__call__(pc1, pc2)
        stale = self.last if self.last is not None else np.zeros_like(flow)
        self.last = flow
        return stale


class HalfCloud(forward.Program):
    def __call__(self, pc1, pc2):
        from hplflownet_tpu_torch.pipeline import flow_forward
        valid = np.ones(pc1.shape[0], dtype=bool)
        valid[pc1.shape[0] // 2:] = False
        flow = flow_forward(self.model, self.spec, pc1, pc2, valid1=valid,
                            adjoint_plans=False)
        return flow.cpu().numpy()


FAULTS = ByEntry("FAULTS", {
    "train": {"unchanged": Unchanged, "half_batch": HalfBatch, "stale_loss": StaleLoss},
    "forward": {"stale_flow": StaleFlow, "half_cloud": HalfCloud}})
