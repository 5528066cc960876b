"""Device choice for the port's entry points, and device constants.

The port runs on a CUDA card unless the caller asks for the CPU: with no
device given and no card present, the entry points raise instead of quietly
running the plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "device_constant", "scalar"]

_CONSTANTS: dict = {}


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the current CUDA card,
    and a bare "cuda" gets the current card's index (as tensors report it)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "hplflownet_tpu_torch runs on a CUDA device by default and "
                "torch sees none; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def device_constant(arr: np.ndarray, device) -> torch.Tensor:
    """``arr`` on ``device``, copied once and cached.

    A copy from host memory to the card synchronises the stream; the
    forward's static tables (elevation matrix, packed stencil deltas, the
    correlation inverse map) are therefore copied on first use only, so the
    host can run ahead of the card.  Callers must not write to the result.
    """
    arr = np.ascontiguousarray(arr)
    key = (arr.dtype.str, arr.shape, arr.tobytes(), str(torch.device(device)))
    t = _CONSTANTS.get(key)
    if t is None:
        t = torch.from_numpy(arr.copy()).to(device)
        _CONSTANTS[key] = t
    return t


def scalar(value, device, dtype=torch.float32) -> torch.Tensor:
    """A 0-dim tensor made on ``device`` by a fill, with no host copy."""
    return torch.full((), value, dtype=dtype, device=device)
