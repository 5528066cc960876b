"""Carry JAX parameter and optimizer trees across to the port, and seeded
parameters.

A JAX parameter tree is nested dicts of arrays, ``{"params": {module:
{name: array}}}`` — the format of the trained-weight pickles.  The port's
modules use the flax names and layouts, so the tree maps onto
``state_dict`` keys ``"module.name"`` one for one and no array is
transposed.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

__all__ = ["params_from_jax", "opt_state_from_jax", "seeded_jax_params"]


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def _tensors(tree, device) -> dict:
    if set(tree) == {"params"}:
        tree = tree["params"]
    return {k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True)).to(device)
            for k, v in _flatten(tree)}


def params_from_jax(tree: dict, model: nn.Module | None = None):
    """The port's ``state_dict`` for a JAX parameter tree.

    ``tree`` may be the whole ``{"params": ...}`` dict or its inner dict.
    With ``model``, the state is loaded into it (strict: every name and
    shape must match) and the model is returned.
    """
    state = _tensors(tree, "cpu")
    if model is None:
        return state
    own = model.state_dict()
    for k, v in state.items():
        if k in own and own[k].shape != v.shape:
            raise ValueError(f"{k}: JAX shape {tuple(v.shape)} vs port "
                             f"{tuple(own[k].shape)}")
    model.load_state_dict(state, strict=True)
    return model


def opt_state_from_jax(opt_state, device=None):
    """The port's ``AdamState`` for an optax ``inject_hyperparams(adam)``
    state whose leaves are numpy arrays (``jax.device_get`` of it).

    ``opt_state`` is that state object (``.inner_state[0]`` holds mu, nu and
    count, ``.hyperparams["learning_rate"]`` the rate) or a dict with keys
    ``mu``, ``nu``, ``count`` and ``learning_rate``.  The moments' trees map
    onto ``state_dict`` names as :func:`params_from_jax` maps parameters.
    ``device`` defaults to the CUDA card.
    """
    from .device import resolve_device
    from .train.step import AdamState
    dev = resolve_device(device)
    if isinstance(opt_state, dict):
        mu, nu = opt_state["mu"], opt_state["nu"]
        count, lr = opt_state["count"], opt_state["learning_rate"]
    else:
        adam = opt_state.inner_state[0]
        mu, nu, count = adam.mu, adam.nu, adam.count
        lr = opt_state.hyperparams["learning_rate"]
    return AdamState(
        mu=_tensors(mu, dev), nu=_tensors(nu, dev),
        count=torch.tensor(int(np.asarray(count)), dtype=torch.int32, device=dev),
        learning_rate=torch.tensor(float(np.asarray(lr)), dtype=torch.float32,
                                   device=dev))


def seeded_jax_params(model: nn.Module, seed: int = 0) -> dict:
    """A JAX-layout parameter tree for ``model``'s parameters, from a seed.

    Kernels are Glorot-normal with the stencil axis counted into both fans
    (flax ``glorot_normal(in_axis=-2, out_axis=-1)``); biases are small
    normals so that the bias paths carry nonzero values.
    """
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for name, p in model.named_parameters():
        shape = tuple(p.shape)
        if name.endswith("kernel"):
            field = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
            fan_in, fan_out = shape[-2] * field, shape[-1] * field
            std = math.sqrt(2.0 / (fan_in + fan_out))
            arr = rng.randn(*shape) * std
        else:
            arr = rng.randn(*shape) * 0.01
        mod, leaf = name.rsplit(".", 1)
        node = tree
        for part in mod.split("."):
            node = node.setdefault(part, {})
        node[leaf] = arr.astype(np.float32)
    return {"params": tree}
