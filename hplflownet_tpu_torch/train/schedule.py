"""Learning-rate schedules (reference: main_utils.py:14-30, cmd_args.py:41-49).

A copy of ``hplflownet_tpu/train/schedule.py`` (pure Python; importing it
from the JAX package would load jax).

The reference stores the custom piecewise schedule as *reversed* CSV lists
and scans for the first switch epoch <= current epoch; here the schedule is
kept in natural ascending order.
"""

from __future__ import annotations

from bisect import bisect_right
from typing import Sequence

__all__ = ["lr_at_epoch", "make_lr_schedule"]


def lr_at_epoch(
    epoch: int,
    *,
    custom_lr: bool,
    lr: float,
    lrs: Sequence[float] | None = None,
    lr_switch_epochs: Sequence[int] | None = None,
    lr_decay_rate: float | None = None,
    lr_decay_epochs: int | None = None,
    lr_clip: float = 0.0,
) -> float:
    """Epoch -> learning rate.

    custom_lr=True: piecewise-constant — lrs[i] applies from
    lr_switch_epochs[i] (ascending) until the next switch.
    custom_lr=False: exponential decay clipped at lr_clip.
    """
    if custom_lr:
        assert lrs is not None and lr_switch_epochs is not None
        assert list(lr_switch_epochs) == sorted(lr_switch_epochs)
        i = bisect_right(list(lr_switch_epochs), epoch) - 1
        return float(lrs[max(i, 0)])
    value = lr * (lr_decay_rate ** (epoch // lr_decay_epochs))
    return float(max(value, lr_clip))


def make_lr_schedule(args) -> "callable":
    """Adapter from a parsed config object to an epoch->lr callable."""
    if getattr(args, "custom_lr", False):
        return lambda epoch: lr_at_epoch(
            epoch, custom_lr=True, lr=args.lr,
            lrs=args.lrs, lr_switch_epochs=args.lr_switch_epochs)
    return lambda epoch: lr_at_epoch(
        epoch, custom_lr=False, lr=args.lr,
        lr_decay_rate=args.lr_decay_rate,
        lr_decay_epochs=args.lr_decay_epochs,
        lr_clip=getattr(args, "lr_clip", 0.0))
