"""What the new per-layer readers share: the card's self time per call
under every span of one name, wherever it sits (``flowbench.layers``'s
span paths), and the calls of the layers' profiled stretch."""

from __future__ import annotations

from flowbench.layers import value
from flowbench.run import PROFILED_CALLS

__all__ = ["self_ms", "profiled_items"]


def self_ms(rec, entry: str, name: str):
    """Summed self device ms a call of the spans named ``name`` (the last
    part of their paths) in a run on the card with ``entry``; None where
    the program has no such span."""
    spans = value(rec, entry, "spans")
    if spans is None:
        return None
    got = [v["device_ms"] for path, v in spans.items()
           if path.rsplit("/", 1)[-1] == name]
    if not got or any(ms is None for ms in got):
        return None
    return sum(got)


def profiled_items(rec) -> list:
    """The pool items of the layers' profiled calls (``flowbench.layers``:
    call j on item j mod the pool)."""
    pool = int(rec.session.mix["pool"])
    return [j % pool for j in range(PROFILED_CALLS[rec.entry])]
