"""Synthetic clouds and measured default capacities (numpy only).

The port's own copy of ``hplflownet_tpu/lattice/capacity.py`` (that module
is numpy-only, but importing it runs the JAX package's ``__init__``).

Vertex counts are not monotone down the pyramid: a mild coarsening step
grows the table (252 -> 521 for a 64-point cloud at scale ratio 2/3), so
default capacities are measured on synthetic FT3D-like frustum clouds, the
worst over a few seeds, padded and aligned.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np

__all__ = ["synthetic_frustum_clouds", "measured_default_capacities",
           "count_vertices_np"]


def synthetic_frustum_clouds(batch, n, seed=0, flow_scale=0.1, patches=300):
    """FT3D-like clouds: points on planar patches inside a 35 m frustum.

    Returns ``(pc1, pc2)``, each ``(batch, n, 3)`` float32; the same numbers
    as the JAX package's function for the same arguments.
    """
    rng = np.random.RandomState(seed)
    out1, out2 = [], []
    for _ in range(batch):
        centers = np.stack([
            rng.uniform(-15, 15, patches),
            rng.uniform(-8, 8, patches),
            rng.uniform(2, 34, patches),
        ], axis=1).astype(np.float32)
        which = rng.randint(0, patches, n)
        local = rng.randn(n, 3).astype(np.float32)
        normals = rng.randn(patches, 3).astype(np.float32)
        normals /= np.linalg.norm(normals, axis=1, keepdims=True)
        local -= (local * normals[which]).sum(1, keepdims=True) * normals[which]
        pc1 = centers[which] + 0.8 * local
        flow = flow_scale * rng.randn(patches, 3).astype(np.float32)
        pc2 = pc1 + flow[which] + 0.01 * rng.randn(n, 3).astype(np.float32)
        out1.append(pc1)
        out2.append(pc2)
    return np.stack(out1), np.stack(out2)


def _elevation_matrix(d: int) -> np.ndarray:
    d1 = d + 1
    e = np.zeros((d1, d), np.float64)
    for i in range(d):
        e[: i + 1, i] = 1.0
        e[i + 1, i] = -(i + 1)
        e[:, i] *= math.sqrt(1.0 / ((i + 1) * (i + 2)))
    return e


def _simplex_keys(elevated: np.ndarray, d: int) -> np.ndarray:
    """(N, d1, d1) int64 lattice keys of each point's simplex corners."""
    d1 = d + 1
    elevated = elevated.astype(np.float32)
    greedy = np.round(elevated / d1) * d1
    el_minus_gr = elevated - greedy
    order = np.argsort(-el_minus_gr, axis=1, kind="stable")
    rank = np.argsort(order, axis=1, kind="stable").astype(np.int64)
    rsum = greedy.sum(axis=1, keepdims=True) / d1
    rank_f = rank.astype(np.float32)
    cond = (((rank_f >= d1 - rsum) & (rsum > 0))
            | ((rank_f < -rsum) & (rsum < 0))).astype(np.float32)
    sign = np.where(rsum > 0, -1.0, np.where(rsum < 0, 1.0, 0.0)
                    ).astype(np.float32)
    greedy = greedy + d1 * sign * cond
    rank = rank + (d1 * sign * cond).astype(np.int64) + rsum.astype(np.int64)
    canonical = np.tile(np.arange(d1, dtype=np.int64), (d1, 1))
    for i in range(1, d1):
        canonical[-i:, i] = i - d1
    return greedy.astype(np.int64)[:, None, :] + np.transpose(
        canonical[rank], (0, 2, 1))


def count_vertices_np(points: np.ndarray,
                      scales: Sequence[float], d: int = 3) -> list:
    """Per-scale occupied-vertex counts of the multi-scale chain."""
    d1 = d + 1
    e = _elevation_matrix(d).T.astype(np.float32)
    std = np.float32(d1 * math.sqrt(2.0 / 3.0))
    elev = (points.astype(np.float32) * np.float32(scales[0])) @ e * std
    counts = []
    for i, s in enumerate(scales):
        keys = _simplex_keys(elev, d)
        uniq = np.unique(keys.reshape(-1, d1), axis=0)
        counts.append(len(uniq))
        if i + 1 < len(scales):
            elev = uniq.astype(np.float32) * np.float32(scales[i + 1] / s)
    return counts


def measured_default_capacities(
    num_points: int,
    scales: Sequence[Sequence[float]],
    d: int = 3,
    seeds: Sequence[int] = (0, 1, 2, 3),
    slack: float = 1.3,
    align: int = 128,
) -> list:
    """Static capacities measured on synthetic clouds at ``num_points``."""
    scale_vals = [float(row[0]) for row in scales]
    worst = np.zeros(len(scale_vals), np.int64)
    for seed in seeds:
        if d == 3:
            pc1, pc2 = synthetic_frustum_clouds(1, num_points, seed=seed)
            clouds = (pc1[0], pc2[0])
        else:
            rng = np.random.RandomState(seed)
            clouds = (rng.randn(num_points, d).astype(np.float32) * 2.0,)
        for pc in clouds:
            worst = np.maximum(worst, count_vertices_np(pc, scale_vals, d))
    return [max(align, int(-(-int(w * slack) // align) * align))
            for w in worst]
