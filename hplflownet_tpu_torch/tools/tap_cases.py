"""Edge cases for ``stencil_tap_tables_sum`` (kernel 4), made from a seed.

:func:`tap_cases` gives a list of :class:`TapCase`: float32 tables (H, F x
C), int32 neighbour rows (F, H_out) with -1 for an absent tap, and C.  The
tests hold the plain version against numpy and, where C is a multiple of
128 (what the TPU kernel takes), the JAX package's kernel in interpret mode;
``chip_smoke.py`` holds the CUDA kernel against the plain version in
float32 and bf16.  Named for what they hold:

* ``absent_single``: 10 output vertices with no present tap and 10 with
  exactly one; H_out 257 (not a multiple of any block);
* ``c384``: C 384, three times the 128-lane width, so a vertex's row
  spans more than one load per lane;
* ``corr_c64``: the correlation adjoint's 65 taps of C 64, 40% absent;
* ``c36``: C 36, not a multiple of the 8-element (16-byte) bf16 vector;
* ``c3``: C 3 (6 / 12-byte rows: 2- and 4-byte loads).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["TapCase", "tap_cases"]


@dataclass
class TapCase:
    name: str
    tables: np.ndarray     # (H, F * C) float32, tap-major column groups
    nb: np.ndarray         # (F, H_out) int32, -1 absent
    c: int


def _case(rng, name, h, f, c, h_out, absent):
    tables = rng.randn(h, f * c).astype(np.float32)
    nb = rng.randint(0, h, (f, h_out))
    nb = np.where(rng.rand(f, h_out) < absent, -1, nb).astype(np.int32)
    return TapCase(name, tables, nb, c)


def tap_cases(seed: int = 0) -> list:
    """Kernel 4's edge cases (see the module's note)."""
    rng = np.random.RandomState(seed + 3)
    base = _case(rng, "absent_single", 300, 15, 128, 257, 0.3)
    base.nb[:, :10] = -1
    base.nb[:, 10:20] = -1
    taps = rng.randint(0, 15, 10)
    base.nb[taps, np.arange(10, 20)] = rng.randint(0, 300, 10)
    return [base,
            _case(rng, "c384", 200, 7, 384, 150, 0.2),
            _case(rng, "corr_c64", 500, 65, 64, 333, 0.4),
            _case(rng, "c36", 100, 9, 36, 77, 0.2),
            _case(rng, "c3", 50, 5, 3, 41, 0.2)]
