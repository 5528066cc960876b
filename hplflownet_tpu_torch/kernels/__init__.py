"""The port's CUDA kernels, each beside its plain PyTorch version.

Every kernel replaces one Pallas TPU kernel of ``hplflownet_tpu``:

* ``stencil.stencil_gather_matmul`` (csrc/stencil_gather_matmul.cu) replaces
  ``hplflownet_tpu/ops/pallas_stencil.py`` ``stencil_gather_matmul``;
* ``splat.rank_reduce`` (csrc/rank_reduce.cu) replaces
  ``blocked_rank_partial`` plus ``segment._combine``;
* ``dkernel.stencil_dkernel`` (csrc/stencil_dkernel.cu) replaces
  ``stencil_dkernel``, the stencil's weight gradient;
* ``tap_tables.stencil_tap_tables_sum`` (csrc/stencil_tap_tables_sum.cu)
  replaces ``stencil_tap_tables_sum``, the correlation adjoint's gather-sum;
* ``rank_fused.blocked_rank_reduce`` (csrc/blocked_rank_reduce.cu) replaces
  ``blocked_rank_reduce``, the fused rank-mode reduction (``HPL_RANK_FUSED=1``);
* ``take.row_take`` (csrc/row_take.cu) replaces the gather lab's
  ``pallas_take`` (``tools/gather_experiments.py``);
* ``rank_partial.rank_partial`` (csrc/rank_partial.cu) replaces the
  rank-partial lab's ``variant`` (``tools/rank_partial_lab.py``).

The two stencil kernels walk a stencil plan per neighbour table
(``stencil_plan.py``: the row order and per-tap vertex lists, plain
PyTorch), which the model makes once per pair.

A wrapper launches its kernel for CUDA tensors and runs the plain version
for CPU tensors; a CUDA tensor never falls back.  The one exception is
explicit: inside ``with plain_kernels():`` the wrappers run their plain
versions on every device, so that a caller can hold a whole forward (and
its backward) against the plain path on the same card.  Each wrapper counts
its launches in a plain int attribute, ``wrapper.launches``.

Sources are compiled with ``nvcc`` at first use into ``_build/`` (see
``_build.py``); importing this package needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

__all__ = ["plain_kernels", "plain_forced", "backward_like_forward",
           "main_path_wrappers", "count_launches"]

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


def backward_like_forward(backward):
    """Decorate an autograd Function's ``backward`` to run under the
    ``plain_kernels()`` setting its forward saw (``ctx.plain_kernels``).

    Autograd runs the backward of CUDA tensors on a thread of its own, which
    does not inherit the caller's context variables.
    """
    @functools.wraps(backward)
    def wrapped(ctx, *grads):
        with plain_kernels(ctx.plain_kernels):
            return backward(ctx, *grads)
    return wrapped


def main_path_wrappers() -> dict:
    """The wrappers of kernels 1-4, the ones the forward and the train step
    launch, by name."""
    from .dkernel import stencil_dkernel
    from .splat import rank_reduce
    from .stencil import stencil_gather_matmul
    from .tap_tables import stencil_tap_tables_sum
    return {"stencil_gather_matmul": stencil_gather_matmul,
            "rank_reduce": rank_reduce, "stencil_dkernel": stencil_dkernel,
            "stencil_tap_tables_sum": stencil_tap_tables_sum}


def count_launches(fn, wrappers: dict | None = None):
    """``fn()`` with the wrappers' launch counts (kernels 1-4 by default)
    set to 0 just before and read just after -> (result, {name: count})."""
    wrappers = main_path_wrappers() if wrappers is None else wrappers
    for w in wrappers.values():
        w.launches = 0
    out = fn()
    return out, {k: w.launches for k, w in wrappers.items()}
