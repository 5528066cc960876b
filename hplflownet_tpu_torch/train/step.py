"""Train and eval steps: lattice build + forward + EPE3D + backward + Adam.

Port of ``hplflownet_tpu/train/step.py``.  The step runs eagerly on the
model's device: the pyramid is built under ``torch.no_grad()`` with the
backward's inverse maps (``adjoint_plans=True``), the model runs with the
state's parameters (``torch.func.functional_call``), ``torch.autograd``
takes the gradient through the ops' hand-derived backward passes, and Adam
updates the parameters.

Adam is written here as a plain function on tensors, in optax's order of
operations (``optax.inject_hyperparams(optax.adam)``: b1 0.9, b2 0.999,
eps 1e-8, eps_root 0, no weight decay; every hyperparameter a float32
scalar).  The state keeps the step count and the learning rate as device
tensors, so ``on_overflow="skip"`` selects parameters, moments and count
with ``torch.where`` and the learning rate can change between steps, both
without a host synchronisation (``torch.optim.Adam`` keeps its step on the
host).
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch
from torch import nn
from torch.func import functional_call

from ..device import resolve_device, scalar
from ..lattice.build import LatticeSpec, build_pyramid
from ..models.losses import epe3d_loss

__all__ = ["AdamState", "TrainState", "create_train_state",
           "set_learning_rate", "adam_update", "loss_and_grad",
           "make_train_step", "make_eval_step"]

B1, B2, EPS = 0.9, 0.999, 1e-8
_INT32_MAX = int(np.iinfo(np.int32).max)


class AdamState(NamedTuple):
    """optax's ``ScaleByAdamState`` plus the injected learning rate."""

    mu: dict                     # name -> first moment (f32, like the param)
    nu: dict                     # name -> second moment
    count: torch.Tensor          # () int32 updates taken
    learning_rate: torch.Tensor  # () f32


class TrainState(NamedTuple):
    params: dict                 # name -> f32 tensor (``state_dict`` names)
    opt_state: AdamState
    step: torch.Tensor           # () int32


def create_train_state(params, learning_rate: float = 1e-4,
                       device=None) -> TrainState:
    """A fresh state for ``params``: a model (its parameters) or a mapping
    of names to arrays.  Lives on ``device``, the CUDA card by default."""
    dev = resolve_device(device)
    if isinstance(params, nn.Module):
        params = dict(params.named_parameters())
    params = {k: torch.as_tensor(v).detach().to(dev, torch.float32).clone()
              for k, v in params.items()}
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = AdamState(mu=zeros, nu={k: torch.zeros_like(v) for k, v in zeros.items()},
                    count=torch.zeros((), dtype=torch.int32, device=dev),
                    learning_rate=scalar(learning_rate, dev))
    return TrainState(params=params, opt_state=opt,
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    """The state with its learning rate replaced (a device fill, no copy)."""
    opt = state.opt_state
    return state._replace(opt_state=opt._replace(
        learning_rate=scalar(lr, opt.learning_rate.device)))


def adam_update(grads: Mapping[str, torch.Tensor], opt: AdamState,
                params: Mapping[str, torch.Tensor],
                keep: torch.Tensor | None = None):
    """One Adam update -> (new params, new AdamState).

    ``keep`` (a () bool tensor) selects, on the device, between the updated
    and the old parameters, moments and count: the update of a step whose
    pyramid overflowed is discarded without a host synchronisation.
    """
    names = list(params)
    dev = opt.count.device
    b1, b2 = scalar(B1, dev), scalar(B2, dev)
    one_b1, one_b2 = 1 - b1, 1 - b2            # float32, as optax's
    g = [grads[k] for k in names]
    p = [params[k] for k in names]
    mu_old = [opt.mu[k] for k in names]
    nu_old = [opt.nu[k] for k in names]
    # optax: (1 - b) * g**order + b * moment, each product rounded
    mu = torch._foreach_add(torch._foreach_mul(g, one_b1),
                            torch._foreach_mul(mu_old, b1))
    nu = torch._foreach_add(torch._foreach_mul(torch._foreach_mul(g, g), one_b2),
                            torch._foreach_mul(nu_old, b2))
    count = torch.where(opt.count < _INT32_MAX, opt.count + 1, opt.count)
    mu_hat = torch._foreach_div(mu, 1 - torch.pow(b1, count))
    nu_hat = torch._foreach_div(nu, 1 - torch.pow(b2, count))
    den = torch._foreach_add(torch._foreach_sqrt(nu_hat), EPS)
    upd = torch._foreach_mul(torch._foreach_div(mu_hat, den), -opt.learning_rate)
    new_p = torch._foreach_add(p, upd)
    if keep is not None:
        new_p = [torch.where(keep, a, b) for a, b in zip(new_p, p)]
        mu = [torch.where(keep, a, b) for a, b in zip(mu, mu_old)]
        nu = [torch.where(keep, a, b) for a, b in zip(nu, nu_old)]
        count = torch.where(keep, count, opt.count)
    return (dict(zip(names, new_p)),
            opt._replace(mu=dict(zip(names, mu)), nu=dict(zip(names, nu)),
                         count=count))


def _scales_overflow(scales) -> torch.Tensor:
    """Total dropped work across a pyramid: capacity, probe-window and
    stencil-window overflow (the last two are always 0 in the port)."""
    total = torch.zeros((), dtype=torch.int32, device=scales[0].pc1_overflow.device)
    for sp in scales:
        total = (total + sp.pc1_overflow + sp.pc2_overflow
                 + sp.probe_overflow + sp.stencil_overflow)
    return total


def _batch_to(batch: Mapping, device) -> dict:
    kinds = {"pc1": torch.float32, "pc2": torch.float32, "sf": torch.float32,
             "valid1": torch.bool, "valid2": torch.bool}
    return {k: torch.as_tensor(batch[k]).to(device=device, dtype=dt)
            for k, dt in kinds.items()}


def _batched_pred(model, spec: LatticeSpec, params, batch,
                  adjoint_plans: bool = True):
    """batch: pc1, pc2 (B, N, d), valid1/2 (B, N); one sample at a time, as
    ``lax.map`` does in JAX.  -> (pred (B, N, d), overflow)."""
    preds = []
    overflow = None
    for b in range(batch["pc1"].shape[0]):
        pc1, pc2 = batch["pc1"][b], batch["pc2"][b]
        with torch.no_grad():
            scales = build_pyramid(spec, pc1, pc2, batch["valid1"][b],
                                   batch["valid2"][b],
                                   adjoint_plans=adjoint_plans)
        preds.append(functional_call(model, params, (pc1, pc2, scales)))
        o = _scales_overflow(scales)
        overflow = o if overflow is None else overflow + o
    return torch.stack(preds), overflow


def _batched_loss(model, spec: LatticeSpec, params, batch,
                  adjoint_plans: bool = True):
    """:func:`_batched_pred` and the batch's EPE3D (``sf`` (B, N, d) the
    target).  -> (loss, pred, overflow)."""
    pred, overflow = _batched_pred(model, spec, params, batch, adjoint_plans)
    return epe3d_loss(pred, batch["sf"], batch["valid1"]), pred, overflow


def _param_device(model) -> torch.device:
    return next(model.parameters()).device


def loss_and_grad(model, spec: LatticeSpec, params: Mapping, batch: Mapping):
    """-> (loss, overflow, {name: gradient}) at ``params`` on one batch."""
    batch = _batch_to(batch, _param_device(model))
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    loss, _, overflow = _batched_loss(model, spec, leaves, batch)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                materialize_grads=True)
    return loss.detach(), overflow, dict(zip(leaves, grads))


def make_train_step(model, spec: LatticeSpec, learning_rate: float = 1e-4,
                    on_overflow: str = "keep", device=None):
    """-> (init_state, train_step), as the JAX package's.

    ``train_step(state, batch) -> (state, loss)``;
    ``train_step.with_overflow(state, batch) -> (state, loss, overflow)``.
    ``on_overflow="skip"`` discards the whole update (parameters, moments
    and step count keep their old values) when the pyramid reports any
    overflow; "keep" applies it regardless.  The model's parameters must be
    on ``device``, the CUDA card unless the caller passes another.
    """
    if on_overflow not in ("keep", "skip"):
        raise ValueError(f"on_overflow must be 'keep' or 'skip', got {on_overflow!r}")
    dev = resolve_device(device)
    if _param_device(model) != dev:
        raise ValueError(f"the model's parameters are on {_param_device(model)}, "
                         f"not on {dev}")

    def init_state(params=None) -> TrainState:
        return create_train_state(model if params is None else params,
                                  learning_rate, device=dev)

    def with_overflow(state: TrainState, batch):
        loss, overflow, grads = loss_and_grad(model, spec, state.params, batch)
        keep = (overflow == 0) if on_overflow == "skip" else None
        params, opt = adam_update(grads, state.opt_state, state.params, keep)
        step = state.step + 1
        if keep is not None:
            step = torch.where(keep, step, state.step)
        return TrainState(params=params, opt_state=opt, step=step), loss, overflow

    def train_step(state: TrainState, batch):
        state, loss, _ = with_overflow(state, batch)
        return state, loss

    train_step.with_overflow = with_overflow
    return init_state, train_step


def make_eval_step(model, spec: LatticeSpec):
    """Forward + per-batch loss, no update: ``eval_step(params, batch) ->
    (loss, pred)``, ``params`` None for the model's own.  The port's kernels
    are window-free, so there is no exact-mode twin."""

    def with_overflow(params, batch):
        batch = _batch_to(batch, _param_device(model))
        p = dict(model.named_parameters()) if params is None else params
        with torch.no_grad():
            return _batched_loss(model, spec, p, batch, adjoint_plans=False)

    def eval_step(params, batch):
        loss, pred, _ = with_overflow(params, batch)
        return loss, pred

    eval_step.with_overflow = with_overflow
    return eval_step
