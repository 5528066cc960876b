"""The port's CUDA kernels, each beside its plain PyTorch version.

Every kernel replaces one Pallas TPU kernel of ``hplflownet_tpu``:

* ``stencil.stencil_gather_matmul`` (csrc/stencil_gather_matmul.cu) replaces
  ``hplflownet_tpu/ops/pallas_stencil.py`` ``stencil_gather_matmul``;
* ``splat.rank_reduce`` (csrc/rank_reduce.cu) replaces
  ``blocked_rank_partial`` plus ``segment._combine``.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; a CUDA tensor never falls back.  The one exception is
explicit: inside ``with plain_kernels():`` the wrappers run their plain
versions on every device, so that a caller can hold a whole forward against
the plain path on the same card.  Each wrapper counts its launches in a
plain int attribute, ``wrapper.launches``.

Sources are compiled with ``nvcc`` at first use into ``_build/`` (see
``_build.py``); importing this package needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import contextlib
import contextvars

__all__ = ["plain_kernels", "plain_forced"]

_PLAIN: contextvars.ContextVar = contextvars.ContextVar("plain_kernels",
                                                        default=False)


@contextlib.contextmanager
def plain_kernels(enabled: bool = True):
    """Run every wrapper's plain PyTorch version, on any device."""
    token = _PLAIN.set(bool(enabled))
    try:
        yield
    finally:
        _PLAIN.reset(token)


def plain_forced() -> bool:
    return _PLAIN.get()
