"""EPE3D, Adam and the train step in plain float32 PyTorch.

* EPE3D: the mean over valid points of ``||pred - target||_2``.
* Adam (Kingma & Ba, 2015) as optax applies it: ``mu = (1 - b1) g + b1 mu``,
  ``nu = (1 - b2) g^2 + b2 nu``, ``p -= lr * mu_hat / (sqrt(nu_hat) + eps)``
  with b1 0.9, b2 0.999, eps 1e-8 and no weight decay.
* A step: build the pair's pyramid, run :func:`.model.forward`, take the
  loss's gradient with autograd, apply Adam.  A pyramid that drops a
  vertex or a point is reported, and its step is skipped (the
  configuration's ``overflow_mode: skip``).
"""

from __future__ import annotations

import torch

from . import lattice, model

__all__ = ["epe3d", "Adam", "Trainer", "train_steps", "B1", "B2", "EPS"]

B1, B2, EPS = 0.9, 0.999, 1e-8


def epe3d(pred: torch.Tensor, target: torch.Tensor, valid=None) -> torch.Tensor:
    err = torch.linalg.vector_norm(pred - target, dim=-1)
    if valid is None:
        return err.mean()
    w = valid.to(err.dtype)
    return (err * w).sum() / w.sum().clamp_min(1.0)


class Adam:
    def __init__(self, params: dict, lr: float):
        self.lr = lr
        self.count = 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> dict:
        self.count += 1
        out = {}
        for k, p in params.items():
            g = grads[k]
            self.mu[k] = (1 - B1) * g + B1 * self.mu[k]
            self.nu[k] = (1 - B2) * g * g + B2 * self.nu[k]
            mu_hat = self.mu[k] / (1 - B1 ** self.count)
            nu_hat = self.nu[k] / (1 - B2 ** self.count)
            out[k] = p - self.lr * mu_hat / (torch.sqrt(nu_hat) + EPS)
        return out


class Trainer:
    """Plain float32 Adam steps from ``params``, one sample a step."""

    def __init__(self, cfg, params: dict, capacities, q=None):
        self.cfg, self.capacities, self.q = cfg, capacities, q
        self.params = {k: v.detach().to(torch.float32).clone()
                       for k, v in params.items()}
        self.opt = Adam(self.params, float(cfg["learning_rate"]))

    def step(self, batch: dict):
        """One step on ``batch`` (pc1, pc2, sf (N, 3) tensors) -> (loss,
        gradients, overflow); the update is skipped where the pyramid
        dropped anything."""
        with torch.no_grad():
            scales = lattice.build_pyramid(self.cfg["scales_filter_map"],
                                           self.capacities, batch["pc1"],
                                           batch["pc2"])
        overflow = sum(s.cloud1.overflow + s.cloud2.overflow for s in scales)
        leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
        pred = model.forward(self.cfg, leaves, batch["pc1"], batch["pc2"], scales,
                             q=self.q)
        loss = epe3d(pred, batch["sf"])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        if overflow == 0:
            self.params = self.opt.step(self.params, grads)
        return float(loss.detach()), grads, overflow


def train_steps(cfg, params: dict, batches, capacities, q=None):
    """Adam steps from ``params`` over ``batches`` -> (losses, first step's
    gradients, parameters after the last step)."""
    trainer = Trainer(cfg, params, capacities, q)
    losses, first = [], None
    for batch in batches:
        loss, grads, _ = trainer.step(batch)
        losses.append(loss)
        first = grads if first is None else first
    return losses, first, trainer.params
