"""The control: the reference put in the program's place, one precision down.

The configuration computes in bfloat16 with float32 sums, so the control
rounds every operand of every product (features, weights, splat weights)
to float8 e4m3 (clamped to its +-448 range) and sums in float32.  It has
the program's interface (``flowbench.entries.<entry>.Program``), so a
session drives it through the same set-up, window and check; its numbers
must come out over the cell's limits.  The benchmark's runs never use it:
``flowbench/readings.py`` and the tests do.  An entry with no row in
``CONTROLS`` brings its own, ``flowbench.entries.<entry>.CONTROL``.
"""

from __future__ import annotations

import numpy as np
import torch

from .entries import ByEntry
from .reference import lattice, model
from .reference.train import Trainer

__all__ = ["fp8", "ControlForward", "ControlTrain", "CONTROLS"]


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 (values, not gradients)."""
    y = x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).to(x.dtype)
    return x + (y - x).detach()


class ControlForward:
    def __init__(self, cfg, capacities, params, device):
        self.cfg, self.capacities, self.params, self.device = cfg, capacities, params, device

    def _scales(self, pc1, pc2):
        return lattice.build_pyramid(self.cfg["scales_filter_map"], self.capacities,
                                     pc1, pc2)

    def __call__(self, pc1: np.ndarray, pc2: np.ndarray) -> np.ndarray:
        a = torch.from_numpy(pc1).to(self.device)
        b = torch.from_numpy(pc2).to(self.device)
        with torch.no_grad():
            flow = model.forward(self.cfg, self.params, a, b, self._scales(a, b), q=fp8)
        return flow.cpu().numpy()

    def overflow(self, pc1, pc2) -> int:
        a = torch.from_numpy(pc1).to(self.device)
        b = torch.from_numpy(pc2).to(self.device)
        return sum(s.cloud1.overflow + s.cloud2.overflow for s in self._scales(a, b))


class ControlTrain:
    def __init__(self, cfg, capacities, params, device):
        self.device = device
        self.trainer = Trainer(cfg, params, capacities, q=fp8)

    def __call__(self, batch: dict):
        t = {k: torch.as_tensor(batch[k][0]).to(self.device) for k in ("pc1", "pc2", "sf")}
        loss, _, overflow = self.trainer.step(t)
        return loss, overflow

    def first_moment(self) -> dict:
        return self.trainer.opt.mu

    def parameters(self) -> dict:
        return self.trainer.params


CONTROLS = ByEntry("CONTROL", {"forward": ControlForward, "train": ControlTrain})
