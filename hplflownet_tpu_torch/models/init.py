"""Configurable weight initialization (port of ``hplflownet_tpu/models/init.py``).

The reference re-draws every Conv/Linear weight after the model is built,
dispatching on ``args.init``:

* ``normal``     — N(0, gain);
* ``xavier``     — xavier_normal with ``gain``;
* ``kaiming``    — kaiming_normal, a=0, mode=fan_in (gain ignored);
* ``orthogonal`` — orthogonal columns scaled by ``gain``;

and zeroes every bias.  Kernel leaves are the ``*_kernel`` names, with
``in_axis=-2, out_axis=-1`` (leading axes are the receptive field and count
into both fans); ``*_bias`` leaves are zeroed.  The draws come from an
explicit ``torch.Generator``: they are not JAX's numbers for the same seed,
only the same distributions.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch

__all__ = ["reinit_params", "INIT_SCHEMES"]

INIT_SCHEMES = ("normal", "xavier", "kaiming", "orthogonal")


def _fans(shape):
    """(fan_in, fan_out) with in_axis=-2, out_axis=-1, leading = receptive."""
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    return shape[-2] * receptive, shape[-1] * receptive


def _orthogonal(shape, gain: float, gen: torch.Generator) -> torch.Tensor:
    """Orthonormal columns over the flattened (prod(shape[:-1]), shape[-1])
    matrix, scaled by ``gain`` (jax.nn.initializers.orthogonal, column_axis
    -1)."""
    rows, cols = math.prod(shape[:-1]), shape[-1]
    a = torch.randn(max(rows, cols), min(rows, cols), generator=gen,
                    dtype=torch.float64)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if rows < cols:
        q = q.t()
    return (gain * q).reshape(shape).to(torch.float32)


def _draw_kernel(shape, scheme: str, gain: float,
                 gen: torch.Generator) -> torch.Tensor:
    fan_in, fan_out = _fans(shape)
    if scheme == "orthogonal":
        return _orthogonal(shape, gain, gen)
    std = {"normal": gain,
           "xavier": gain * math.sqrt(2.0 / (fan_in + fan_out)),
           "kaiming": math.sqrt(2.0 / fan_in)}[scheme]
    return std * torch.randn(shape, generator=gen, dtype=torch.float32)


def reinit_params(generator: torch.Generator,
                  params: Mapping[str, torch.Tensor], scheme: str = "xavier",
                  gain: float = 1.0) -> dict:
    """Re-draw every ``*_kernel`` per ``scheme`` and zero every ``*_bias``.

    ``params`` maps names to tensors (a ``state_dict``, or a train state's
    parameters); the result has the same names, devices and shapes.  The
    generator is a CPU ``torch.Generator``.  Raises ``NotImplementedError``
    on an unknown scheme, so a mistyped config fails instead of training
    with the default init.
    """
    if scheme not in INIT_SCHEMES:
        raise NotImplementedError(
            f"initialization method [{scheme}] is not implemented")
    out = {}
    for name, leaf in params.items():
        if name.endswith("kernel"):
            w = _draw_kernel(tuple(leaf.shape), scheme, float(gain), generator)
            out[name] = w.to(device=leaf.device, dtype=leaf.dtype)
        elif name.endswith("bias"):
            out[name] = torch.zeros_like(leaf)
        else:
            out[name] = leaf
    return out
