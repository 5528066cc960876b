"""Call-time dispatch switches shared by the lattice ops.

Port of ``hplflownet_tpu/ops/dispatch.py``.  ``exact_mode`` turns off every
route that is not the reference's exact one; in the port that is only the
fused rank-mode reduction (``ops/segment``), since the port's kernels are
window-free and drop nothing.  PyTorch runs eagerly, so the switches are
read when an op is called, not when a graph is traced::

    with exact_mode():
        flow = flow_forward(model, spec, pc1, pc2)
"""

from __future__ import annotations

import contextlib
import contextvars
import os

__all__ = ["exact_mode", "exact_mode_active", "rank_fused_enabled"]

_EXACT_MODE: contextvars.ContextVar = contextvars.ContextVar(
    "exact_mode", default=False)


@contextlib.contextmanager
def exact_mode(enabled: bool = True):
    """Route the ops called inside the block to their exact counterparts."""
    token = _EXACT_MODE.set(bool(enabled))
    try:
        yield
    finally:
        _EXACT_MODE.reset(token)


def exact_mode_active() -> bool:
    return _EXACT_MODE.get()


def rank_fused_enabled() -> bool:
    """The fused single-pass rank reduction (``blocked_rank_reduce``) for
    rank-mode splat plans, instead of the default run-bounds reduction
    (``rank_reduce``).  Off by default; on with the environment variable
    ``HPL_RANK_FUSED=1``, read at each call; always off under
    :func:`exact_mode`, as in the JAX package."""
    if _EXACT_MODE.get():
        return False
    return os.environ.get("HPL_RANK_FUSED", "0") == "1"
