"""Permutohedral lattice geometry: elevation, rounding, barycentric weights.

Port of ``hplflownet_tpu/lattice/geometry.py``.  Points are elevated onto
the ``sum(x) == 0`` hyperplane in (d+1)-dim space, rounded to the nearest
remainder-0 lattice point, and the enclosing simplex is found by ranking the
rounding residuals; each point gets d+1 lattice keys and d+1 barycentric
weights.

Bit-exactness with the JAX package matters here: a 1-ulp difference in an
elevated coordinate can flip a rounding tie and change the lattice.  So

* the elevation is an explicit elementwise sum ``(s0*E0 + s1*E1) + s2*E2``
  in that order, which equals XLA's CPU result bit for bit and, being
  separate eager ops, is never FMA-contracted on any device (a ``matmul``
  differs from it in ~75% of coordinates);
* ranks are compare counts with the JAX tie rule (equal residuals are
  ordered by coordinate index), not a sort.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..device import device_constant, scalar

__all__ = ["expected_std", "elevation_matrix", "elevate",
           "simplex_from_elevated", "KeysBarycentric"]


def expected_std(d: int) -> float:
    """Scale so that unit-variance data spans about two lattice cells."""
    return (d + 1) * math.sqrt(2.0 / 3.0)


@lru_cache(maxsize=None)
def elevation_matrix(d: int) -> np.ndarray:
    """The (d+1, d) elevation matrix E with zero column sums (float32)."""
    left = np.triu(np.ones((d + 1, d), dtype=np.float32))
    left[1:, :] += np.diag(np.arange(-1, -d - 1, -1, dtype=np.float32))
    scale = np.sqrt(
        np.arange(1, d + 1, dtype=np.float32) * np.arange(2, d + 2, dtype=np.float32)
    )
    right = np.diag((1.0 / scale).astype(np.float32))
    return (left @ right).astype(np.float32)


class KeysBarycentric(NamedTuple):
    """Per-point simplex assignment for one cloud at one lattice scale."""

    keys: torch.Tensor         # (N, d1, d1) int32: keys[n, r] = remainder-r vertex
    barycentric: torch.Tensor  # (N, d1) float32
    el_minus_gr: torch.Tensor  # (N, d1) float32


def elevate(points: torch.Tensor, scale: float) -> torch.Tensor:
    """(N, d) metric points -> (N, d+1) float32 elevated coords at ``scale``."""
    d = points.shape[1]
    dev = points.device
    e = device_constant(elevation_matrix(d), dev)                 # (d1, d)
    s = points.to(torch.float32) * scalar(np.float32(scale), dev)
    acc = s[:, 0:1] * e[:, 0]
    for j in range(1, d):
        acc = acc + s[:, j:j + 1] * e[:, j]
    return acc * scalar(np.float32(expected_std(d)), dev)


def simplex_from_elevated(elevated: torch.Tensor) -> KeysBarycentric:
    """Simplex keys, barycentric weights and residuals of (N, d1) coords."""
    d1 = elevated.shape[1]
    d = d1 - 1
    dev = elevated.device
    i32 = torch.int32
    greedy = torch.round(elevated / d1) * d1              # nearest remainder-0
    el_minus_gr = elevated - greedy

    # rank[n, c] = position of coordinate c in descending residual order;
    # j precedes c iff v[j] > v[c], or v[j] == v[c] and j < c
    v_c = el_minus_gr[:, :, None]
    v_j = el_minus_gr[:, None, :]
    idx = torch.arange(d1, dtype=i32, device=dev)
    before = (v_j > v_c) | ((v_j == v_c) & (idx[None, None, :] < idx[None, :, None]))
    rank = before.to(i32).sum(dim=2, dtype=i32)

    # move the rounded point back onto the sum == 0 plane
    remainder_sum = greedy.sum(dim=1, keepdim=True) / d1
    rank_f = rank.to(torch.float32)
    cond = (((rank_f >= d1 - remainder_sum) & (remainder_sum > 0))
            | ((rank_f < -remainder_sum) & (remainder_sum < 0))).to(torch.float32)
    sign = (torch.where(remainder_sum > 0, -1.0, 0.0)
            + torch.where(remainder_sum < 0, 1.0, 0.0))
    greedy = greedy + d1 * sign * cond
    rank = rank + (d1 * sign * cond).to(i32)
    rank = rank + remainder_sum.to(i32)

    # barycentric weights from ascending-order residual differences
    el_minus_gr = elevated - greedy
    u = torch.where(rank[:, :, None] == (d - idx)[None, None, :],
                    el_minus_gr[:, :, None], 0.0).sum(dim=1)
    bary0 = 1.0 + (u[:, :1] - u[:, d:]) / d1
    bary = torch.cat([bary0, (u[:, 1:] - u[:, :-1]) / d1], dim=1)

    # keys[n, r, c] = greedy[n, c] + canonical[rank[n, c], r]
    r_ax = idx[None, :, None]
    keys = (greedy.to(i32)[:, None, :] + r_ax
            - d1 * ((rank[:, None, :] + r_ax) >= d1).to(i32))
    return KeysBarycentric(keys=keys, barycentric=bary, el_minus_gr=el_minus_gr)
