"""Static neighborhood stencils on the permutohedral lattice (numpy only).

The port's own copy of ``hplflownet_tpu/lattice/offsets.py``: importing the
JAX package would load jax, so the three helpers are repeated here.

The stencil for radius ``n`` in ``d``-dim space is the set of points
``n_1*u_1 + ... + n_{d+1}*u_{d+1}`` with ``n_j in [0, n]`` and
``min_j n_j = 0``, where ``u_j = (d+1)*e_j - 1`` are the lattice's principal
directions: ``(n+1)^(d+1) - n^(d+1)`` offsets (15 for n=1, d=3), listed in
lexicographic ``(n_1, ..., n_{d+1})`` order so that filter taps (and hence
carried-over weights) line up with the JAX package.
"""

from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np

__all__ = ["neighborhood_offsets", "filter_size", "tap_negation"]


def filter_size(radius: int, d: int) -> int:
    """Number of stencil taps for a given radius."""
    return (radius + 1) ** (d + 1) - radius ** (d + 1)


@lru_cache(maxsize=None)
def neighborhood_offsets(radius: int, d: int) -> np.ndarray:
    """All lattice offsets for ``radius``, shape ``(filter_size, d+1)`` int32.

    Each row sums to zero (offsets stay on the ``sum == 0`` hyperplane);
    row 0 is the zero offset.
    """
    d1 = d + 1
    rows = []
    for steps in itertools.product(range(radius + 1), repeat=d1):
        if min(steps) != 0:
            continue
        steps = np.asarray(steps, dtype=np.int64)
        rows.append(d1 * steps - steps.sum())
    out = np.stack(rows).astype(np.int32)
    assert out.shape == (filter_size(radius, d), d1)
    assert (out.sum(axis=1) == 0).all()
    return out


@lru_cache(maxsize=None)
def tap_negation(radius: int, d: int) -> tuple:
    """Permutation mapping each tap to the tap of its negated offset.

    The stencil is closed under negation, which makes a transpose stencil the
    same gather with permuted taps (used by the backward passes).
    """
    offs = neighborhood_offsets(radius, d)
    lut = {tuple(int(v) for v in row): i for i, row in enumerate(offs)}
    neg = tuple(lut[tuple(int(-v) for v in row)] for row in offs)
    assert sorted(neg) == list(range(len(offs)))
    return neg
