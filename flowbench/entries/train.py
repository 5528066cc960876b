"""The train entry: ``train.step.make_train_step(...).with_overflow``.

One object, the step with its model and Adam state, is built in set-up,
driven through its first steps (the check's steps, on pool pairs that all
differ) by the same call and feed as the window, and handed on to the
window.  A step takes one sample as host arrays (``pc1``, ``pc2``,
``sf = pc2 - pc1``, ``valid1``, ``valid2``, each with a batch axis of 1),
which the step moves to the card, and ends when its loss is a host float.
It failed if the loss is not finite or its overflow counter is not 0 (the
step is then skipped, ``overflow_mode: skip``).

``correct`` holds the first steps against the reference's float32 steps
from the same weights on the same pairs:

* ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
* ``grad_gap``: over the leaves, the largest gap between the norm of the
  first step's gradient (worked out from Adam's first moment after one
  step, ``mu / (1 - b1)``) and the reference's, over the larger of the
  reference leaf's norm and the median leaf's;
* ``update_gap``: the same for the parameters' change over the steps,
  leaving out the leaves whose reference gradient is under a thousandth of
  the median leaf's (Adam moves them by rounding alone).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import lattice as ref_lattice
from ..reference import model as ref_model
from ..reference import train as ref_train
from ..reference.model import init_params

__all__ = ["init_params", "Program", "Session", "compare", "gaps"]


class Program:
    """The measured program's train step, one sample per step."""

    def __init__(self, cfg, capacities, params, device):
        from hplflownet_tpu_torch.models import MODELS
        from hplflownet_tpu_torch.pipeline import make_lattice_spec
        from hplflownet_tpu_torch.train.step import make_train_step
        self.model = MODELS[cfg["arch"]](
            cfg["scales_filter_map"], dim=cfg["dim"], use_leaky=cfg["use_leaky"],
            bcn_use_bias=cfg["bcn_use_bias"], bcn_use_norm=cfg["bcn_use_norm"],
            last_relu=cfg["last_relu"], compute_dtype=cfg["compute_dtype"],
            device=device)
        self.model.load_state_dict(params, strict=True)
        spec = make_lattice_spec(cfg["scales_filter_map"], capacities)
        init, step = make_train_step(self.model, spec,
                                     learning_rate=float(cfg["learning_rate"]),
                                     on_overflow=cfg["overflow_mode"], device=device)
        self.state = init()
        self._step = step.with_overflow

    def __call__(self, batch: dict):
        """One step -> (loss as a host float, overflow as a host int)."""
        self.state, loss, overflow = self._step(self.state, batch)
        return float(loss), int(overflow)

    def first_moment(self) -> dict:
        return self.state.opt_state.mu

    def parameters(self) -> dict:
        return self.state.params


def _norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.detach().double())) for k, v in tensors.items()}


def gaps(got: dict, want: dict, names) -> float:
    """The worst leaf's ``|got - want|`` over max(want, median of want)."""
    if not names:
        return 0.0
    med = float(np.median([want[k] for k in names]))
    return max(abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in names)


class Session:
    entry = "train"

    def __init__(self, cfg, capacities, mix, pool, params, seed, device,
                 program=Program):
        self.cfg, self.capacities, self.mix = cfg, capacities, mix
        self.pool, self.params, self.seed, self.device = pool, params, seed, device
        self.program = program(cfg, capacities, params, device)
        n = pool.pc1[0].shape[0]
        ones = np.ones((1, n), dtype=bool)
        self.batches = [{"pc1": a[None], "pc2": b[None], "sf": f[None],
                         "valid1": ones, "valid2": ones}
                        for a, b, f in zip(pool.pc1, pool.pc2, pool.sf)]
        self.first = []           # pool pairs of the check's steps
        self.losses = []          # their losses
        self.grad_norms = None    # the first step's gradient norms
        self.after = None         # parameters after the check's steps

    def warm(self, order) -> None:
        """The check's steps, through the window's call: set-up's warm-up."""
        steps = int(self.mix["check"]["steps"])
        b1 = ref_train.B1
        for i in range(steps):
            k = next(order)
            self.first.append(k)
            loss, _ = self.program(self.batches[k])
            self.losses.append(loss)
            if i == 0:
                self.grad_norms = _norms({name: m / (1 - b1) for name, m in
                                          self.program.first_moment().items()})
        self.after = {name: p.detach().clone() for name, p in
                      self.program.parameters().items()}

    def call(self, k: int) -> bool:
        loss, overflow = self.program(self.batches[k])
        return overflow == 0 and np.isfinite(loss)

    def overflowing(self) -> set:
        return set()          # each step reads its own counter

    def release(self):
        self.program = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def _batch(self, k: int) -> dict:
        return {key: torch.from_numpy(getattr(self.pool, key)[k]).to(self.device)
                for key in ("pc1", "pc2", "sf")}

    def reference_steps(self, q=None):
        return ref_train.train_steps(self.cfg, self.params,
                                     [self._batch(k) for k in self.first],
                                     self.capacities, q=q)

    def check(self) -> dict:
        losses, grads, after = self.reference_steps()
        return compare(self.params, self.losses, self.grad_norms, self.after,
                       losses, grads, after)

    def work(self, k: int) -> list:
        log = []
        pc1, pc2 = self._batch(k)["pc1"], self._batch(k)["pc2"]
        with torch.no_grad():
            scales = ref_lattice.build_pyramid(self.cfg["scales_filter_map"],
                                               self.capacities, pc1, pc2)
            ref_model.forward(self.cfg, self.params, pc1, pc2, scales, log=log)
        return log


def compare(init, losses, grad_norms, after, ref_losses, ref_grads, ref_after) -> dict:
    """The three numbers of a training cell's check."""
    loss_gap = max(abs(a - b) / max(abs(b), 1e-30) for a, b in zip(losses, ref_losses))
    ref_g = _norms(ref_grads)
    names = sorted(ref_g)
    med_g = float(np.median([ref_g[k] for k in names]))
    moved = [k for k in names if ref_g[k] >= 1e-3 * med_g]
    delta = _norms({k: after[k].to(init[k].device) - init[k] for k in moved})
    ref_delta = _norms({k: ref_after[k] - init[k] for k in moved})
    return {"loss_gap": {"value": float(loss_gap)},
            "grad_gap": {"value": gaps(grad_norms, ref_g, names)},
            "update_gap": {"value": gaps(delta, ref_delta, moved)}}
