"""Operations and bytes of a pair's work, from the reference's log, and the
roofline arithmetic against the card's published peaks.

The reference (``flowbench.reference.model.forward`` with ``log=``) writes
one entry per product; this module sums them per class of work:

* ``stencil``: a lattice stencil product, ``2 C_in C_out`` operations per
  present (vertex, tap) pair of its table (the blur, ``corr_self``, and
  ``corr_cross`` in its direct (F, Cc) form);
* ``dense``: ``2 K N`` per real row (a scale's valid vertices, a cloud's
  valid points; padding rows are no work);
* ``splat`` and ``slice``: ``2 C`` per present (point, vertex) pair;
* any other kind: the log entry's own ``flops`` (a reference that logs a new
  kind of product says what it costs; :func:`model_flops` refuses an entry
  of an unknown kind without it).

Bytes count each input element read once and each output written once:
inputs at the configuration's compute dtype (bfloat16: 2 bytes), outputs
at its accumulation dtype (float32: 4 bytes), index tables at 4 bytes.
The slice is the exception: its result is charged at the dtype its span
hands on (``flowbench/metrics/slice_fwd_roofline.py``).
The counts depend on the pair's tables, not on how the program computes
them, so a kernel that skips absent work reads higher, never lower.
"""

from __future__ import annotations

from typing import NamedTuple

__all__ = ["PEAKS", "Work", "stencil", "dense", "model_flops", "roofline"]

# NVIDIA H100 SXM data sheet, dense rates (no sparsity), at the 700 W limit.
PEAKS = {"flops": {"bfloat16": 989e12, "float16": 989e12, "tf32": 495e12,
                   "float32": 67e12},
         "bytes_per_s": 3.35e12}
_SIZE = {"bfloat16": 2, "float16": 2, "float32": 4}


class Work(NamedTuple):
    flops: float
    bytes: float

    def __add__(self, other):
        return Work(self.flops + other.flops, self.bytes + other.bytes)

    def scaled(self, k: float) -> "Work":
        return Work(self.flops * k, self.bytes * k)


ZERO = Work(0.0, 0.0)


def _sizes(cfg):
    return _SIZE[cfg["compute_dtype"]], _SIZE[cfg["accumulate_dtype"]]


def stencil(log, cfg, ops=("blur", "corr_self", "corr_cross")) -> Work:
    """The stencil products of ``ops`` in one forward's log."""
    b_in, b_out = _sizes(cfg)
    w = ZERO
    for e in log:
        if e["kind"] == "stencil" and e["op"] in ops:
            w = w + Work(2.0 * e["present"] * e["c_in"] * e["c_out"],
                         b_in * (e["rows_in"] * e["c_in"]
                                 + e["taps"] * e["c_in"] * e["c_out"])
                         + 4 * e["taps"] * e["rows_out"]
                         + b_out * e["rows_out"] * e["c_out"])
    return w


def stencil_dw(log, cfg) -> Work:
    """The stencil weight gradients of one step: per product, the same
    operations as its forward; bytes: the table and the cotangent read, the
    (F, C_in, C_out) gradient written."""
    b_in, b_out = _sizes(cfg)
    w = ZERO
    for e in log:
        if e["kind"] == "stencil":
            w = w + Work(2.0 * e["present"] * e["c_in"] * e["c_out"],
                         b_in * (e["rows_in"] * e["c_in"] + e["rows_out"] * e["c_out"])
                         + 4 * e["taps"] * e["rows_out"]
                         + b_out * e["taps"] * e["c_in"] * e["c_out"])
    return w


def dense(log, cfg) -> Work:
    b_in, b_out = _sizes(cfg)
    w = ZERO
    for e in log:
        if e["kind"] == "dense":
            w = w + Work(2.0 * e["rows"] * e["k"] * e["n"],
                         b_in * (e["rows"] * e["k"] + e["k"] * e["n"])
                         + b_out * e["rows"] * e["n"])
    return w


def model_flops(log) -> float:
    """Every product of one forward."""
    total = 0.0
    for e in log:
        if e["kind"] == "stencil":
            total += 2.0 * e["present"] * e["c_in"] * e["c_out"]
        elif e["kind"] == "dense":
            total += 2.0 * e["rows"] * e["k"] * e["n"]
        elif e["kind"] in ("splat", "slice"):
            total += 2.0 * e["entries"] * e["c"]
        elif "flops" in e:
            total += float(e["flops"])
        else:
            raise ValueError(f"a work log entry of kind {e['kind']!r} has no 'flops'")
    return total


def roofline(work: Work, seconds: float, dtype: str):
    """(share of the roofline in %, "operations" or "bytes"): the least
    time the card could take for ``work``, over ``seconds``."""
    t_ops = work.flops / PEAKS["flops"][dtype]
    t_bytes = work.bytes / PEAKS["bytes_per_s"]
    bound = max(t_ops, t_bytes)
    return 100.0 * bound / seconds, ("operations" if t_ops >= t_bytes else "bytes")
