"""The permutohedral-lattice pyramid in plain PyTorch: the yardstick's own build.

Semantics of HPLFlowNet's lattice (Gu et al., CVPR 2019; Adams et al.,
"Fast high-dimensional filtering using the permutohedral lattice", 2010) as
the measured program states them:

* a point cloud is elevated onto the ``sum == 0`` hyperplane of d+1
  dimensions at a scale, rounded to its enclosing simplex, and splats onto
  the simplex's d+1 vertices with barycentric weights;
* a vertex's id is its rank among the cloud's distinct vertex keys in
  lexicographic key order; vertices past the scale's static ``capacity``
  are dropped (id -1) and counted, as are points whose keys leave the
  packed key range (|coordinate| > 495);
* a blur table row f holds the id of vertex ``key + offset[f]`` (-1 where
  absent); row 0 is the zero offset;
* each deeper scale's points are the previous scale's vertices, their keys
  multiplied by the ratio of the scales in float32.

Everything that decides a vertex key (elevation, rounding, the rank of the
residuals with its tie rule) is the same float32 arithmetic as the program's
build, operation for operation: vertex-derived points sit exactly on
rounding ties, and another order of operations would pick other simplices.
The rest is written independently: keys are one int64 each, vertices come
from ``torch.unique``, and lookups are ``searchsorted`` in the unique keys.
The correlation's displaced table is kept in its direct (F, Cc, H) form.
"""

from __future__ import annotations

import itertools
import math
from typing import NamedTuple

import numpy as np
import torch

__all__ = ["neighborhood_offsets", "filter_size", "elevation_matrix",
           "elevate", "simplex", "Cloud", "Scale", "build_pyramid",
           "KEY_BOUND"]

KEY_BOUND = 495          # |key coordinate| the measured program can pack
_FIELD = 20              # bits per coordinate of the int64 key
_BIAS = 1 << (_FIELD - 1)


def filter_size(radius: int, d: int) -> int:
    return (radius + 1) ** (d + 1) - radius ** (d + 1)


def neighborhood_offsets(radius: int, d: int) -> np.ndarray:
    """(filter_size, d+1) int64 stencil offsets, row 0 the zero offset, in
    lexicographic order of the step counts ``n_j in [0, radius]`` with
    ``min n_j == 0`` (offset ``(d+1) n - sum(n)``)."""
    d1 = d + 1
    rows = [d1 * np.asarray(s, np.int64) - sum(s)
            for s in itertools.product(range(radius + 1), repeat=d1)
            if min(s) == 0]
    return np.stack(rows)


def elevation_matrix(d: int) -> np.ndarray:
    """The (d+1, d) float32 elevation matrix, zero column sums."""
    left = np.triu(np.ones((d + 1, d), dtype=np.float32))
    left[1:, :] += np.diag(np.arange(-1, -d - 1, -1, dtype=np.float32))
    scale = np.sqrt(np.arange(1, d + 1, dtype=np.float32)
                    * np.arange(2, d + 2, dtype=np.float32))
    return (left @ np.diag((1.0 / scale).astype(np.float32))).astype(np.float32)


def _f32(value, device) -> torch.Tensor:
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


def elevate(points: torch.Tensor, scale: float) -> torch.Tensor:
    """(N, d) -> (N, d+1) float32: ``(s0 E0 + s1 E1) + s2 E2`` in that order,
    times ``(d+1) sqrt(2/3)``."""
    d = points.shape[1]
    dev = points.device
    e = torch.from_numpy(elevation_matrix(d)).to(dev)
    s = points.to(torch.float32) * _f32(scale, dev)
    acc = s[:, 0:1] * e[:, 0]
    for j in range(1, d):
        acc = acc + s[:, j:j + 1] * e[:, j]
    return acc * _f32((d + 1) * math.sqrt(2.0 / 3.0), dev)


def simplex(elevated: torch.Tensor):
    """-> (keys (N, d1, d1) int64, barycentric (N, d1), el_minus_gr (N, d1)).

    Residual ranks are compare counts; equal residuals are ordered by
    coordinate index.
    """
    d1 = elevated.shape[1]
    d = d1 - 1
    dev = elevated.device
    greedy = torch.round(elevated / d1) * d1
    el_minus_gr = elevated - greedy
    v_c = el_minus_gr[:, :, None]
    v_j = el_minus_gr[:, None, :]
    idx = torch.arange(d1, dtype=torch.int32, device=dev)
    before = (v_j > v_c) | ((v_j == v_c) & (idx[None, None, :] < idx[None, :, None]))
    rank = before.to(torch.int32).sum(dim=2, dtype=torch.int32)
    remainder_sum = greedy.sum(dim=1, keepdim=True) / d1
    rank_f = rank.to(torch.float32)
    cond = (((rank_f >= d1 - remainder_sum) & (remainder_sum > 0))
            | ((rank_f < -remainder_sum) & (remainder_sum < 0))).to(torch.float32)
    sign = (torch.where(remainder_sum > 0, -1.0, 0.0)
            + torch.where(remainder_sum < 0, 1.0, 0.0))
    greedy = greedy + d1 * sign * cond
    rank = rank + (d1 * sign * cond).to(torch.int32)
    rank = rank + remainder_sum.to(torch.int32)
    el_minus_gr = elevated - greedy
    u = torch.where(rank[:, :, None] == (d - idx)[None, None, :],
                    el_minus_gr[:, :, None], 0.0).sum(dim=1)
    bary0 = 1.0 + (u[:, :1] - u[:, d:]) / d1
    bary = torch.cat([bary0, (u[:, 1:] - u[:, :-1]) / d1], dim=1)
    r_ax = idx[None, :, None]
    keys = (greedy.to(torch.int32)[:, None, :] + r_ax
            - d1 * ((rank[:, None, :] + r_ax) >= d1).to(torch.int32))
    return keys.to(torch.int64), bary, el_minus_gr


def _pack(coords: torch.Tensor) -> torch.Tensor:
    """(..., d1) int64 coordinates -> (...,) int64 keys in lexicographic
    order of the first d coordinates (the last is minus their sum)."""
    d = coords.shape[-1] - 1
    key = torch.zeros(coords.shape[:-1], dtype=torch.int64, device=coords.device)
    for i in range(d):
        key = (key << _FIELD) | (coords[..., i] + _BIAS)
    return key


def _unpack(keys: torch.Tensor, d: int) -> torch.Tensor:
    mask = (1 << _FIELD) - 1
    coords = [((keys >> (_FIELD * (d - 1 - i))) & mask) - _BIAS for i in range(d)]
    coords.append(-sum(coords))
    return torch.stack(coords, dim=-1)


class Cloud(NamedTuple):
    """One cloud at one scale, with H = the scale's capacity rows."""

    offsets: torch.Tensor       # (N, d1) int64 vertex id per simplex corner, -1 absent
    barycentric: torch.Tensor   # (N, d1) float32, zero rows for invalid points
    el_minus_gr: torch.Tensor   # (N, d1) float32, zero rows for invalid points
    keys: torch.Tensor          # (V,) int64 sorted vertex keys, V = num_valid
    coords: torch.Tensor        # (H, d1) int64 vertex coordinates, zero past V
    num_valid: int              # vertices kept (V <= H)
    overflow: int               # vertices dropped past capacity + points out of range
    num_points: int             # valid points


class Scale(NamedTuple):
    cloud1: Cloud
    cloud2: Cloud
    blur1: torch.Tensor | None  # (F, H1) int64 ids, -1 absent
    blur2: torch.Tensor | None  # (F, H2)
    corr1: torch.Tensor | None  # (Cc, H1): cloud-1 ids around each cloud-1 vertex
    cross: torch.Tensor | None  # (F, Cc, H1): cloud-2 ids at key1 + filt[f] + corr[c]


def _cloud(elevated: torch.Tensor, valid: torch.Tensor, capacity: int) -> Cloud:
    n, d1 = elevated.shape
    keys, bary, emg = simplex(elevated)
    in_range = (keys.abs() <= KEY_BOUND).reshape(n, -1).all(dim=1)
    dropped = int((valid & ~in_range).sum())
    valid = valid & in_range
    k = _pack(keys)                                            # (N, d1)
    uniq, inverse = torch.unique(k[valid].reshape(-1), return_inverse=True)
    kept = min(uniq.shape[0], capacity)
    offsets = torch.full((n, d1), -1, dtype=torch.int64, device=k.device)
    offsets[valid] = torch.where(inverse < capacity, inverse, -1).reshape(-1, d1)
    coords = torch.zeros((capacity, d1), dtype=torch.int64, device=k.device)
    coords[:kept] = _unpack(uniq[:kept], d1 - 1)
    zero = torch.zeros_like(bary)
    return Cloud(offsets=offsets,
                 barycentric=torch.where(valid[:, None], bary, zero),
                 el_minus_gr=torch.where(valid[:, None], emg, zero),
                 keys=uniq[:kept], coords=coords, num_valid=kept,
                 overflow=max(uniq.shape[0] - capacity, 0) + dropped,
                 num_points=int(valid.sum()))


def _lookup(cloud: Cloud, coords: torch.Tensor) -> torch.Tensor:
    """Ids in ``cloud`` of the vertices at ``coords`` (..., d1), -1 absent."""
    q = _pack(coords)
    table = cloud.keys
    if table.numel() == 0:
        return torch.full(q.shape, -1, dtype=torch.int64, device=q.device)
    idx = torch.searchsorted(table, q.reshape(-1)).reshape(q.shape)
    hit = table[idx.clamp(max=table.shape[0] - 1)] == q
    return torch.where(hit & (idx < table.shape[0]), idx, -1)


def _stencil(cloud: Cloud, into: Cloud, offsets: np.ndarray) -> torch.Tensor:
    """(F, H) ids in ``into`` of ``cloud``'s vertices + each offset; -1 for
    rows past ``cloud``'s valid vertices."""
    off = torch.from_numpy(offsets).to(cloud.coords.device)
    ids = _lookup(into, cloud.coords[None, :, :] + off[:, None, :])
    live = torch.arange(cloud.coords.shape[0], device=ids.device) < cloud.num_valid
    return torch.where(live[None, :], ids, -1)


def build_pyramid(sfm, capacities, pc1: torch.Tensor, pc2: torch.Tensor,
                  valid1: torch.Tensor | None = None,
                  valid2: torch.Tensor | None = None) -> list:
    """The pyramid of a pair of (N, 3) float32 clouds: one :class:`Scale`
    per row ``(scale, blur_radius, corr_filter_radius, corr_radius)`` of
    ``sfm``, with ``capacities`` vertices per cloud and scale."""
    d = pc1.shape[1]
    dev = pc1.device
    if valid1 is None:
        valid1 = torch.ones(pc1.shape[0], dtype=torch.bool, device=dev)
    if valid2 is None:
        valid2 = torch.ones(pc2.shape[0], dtype=torch.bool, device=dev)
    elev1, elev2 = elevate(pc1, sfm[0][0]), elevate(pc2, sfm[0][0])
    out = []
    for i, (row, cap) in enumerate(zip(sfm, capacities)):
        scale, blur_r, filt_r, corr_r = float(row[0]), *map(int, row[1:4])
        c1, c2 = _cloud(elev1, valid1, cap), _cloud(elev2, valid2, cap)
        blur1 = blur2 = corr1 = cross = None
        if blur_r != -1:
            offs = neighborhood_offsets(blur_r, d)
            blur1, blur2 = _stencil(c1, c1, offs), _stencil(c2, c2, offs)
        if filt_r != -1:
            f_offs = neighborhood_offsets(filt_r, d)
            c_offs = neighborhood_offsets(corr_r, d)
            corr1 = _stencil(c1, c1, c_offs)
            combined = (f_offs[:, None, :] + c_offs[None, :, :]).reshape(-1, d + 1)
            cross = _stencil(c1, c2, combined).reshape(
                len(f_offs), len(c_offs), -1)
        out.append(Scale(c1, c2, blur1, blur2, corr1, cross))
        if i + 1 < len(sfm):
            ratio = np.float32(sfm[i + 1][0]) / np.float32(scale)
            elev1 = c1.coords.to(torch.float32) * _f32(ratio, dev)
            elev2 = c2.coords.to(torch.float32) * _f32(ratio, dev)
            live = torch.arange(cap, device=dev)
            valid1, valid2 = live < c1.num_valid, live < c2.num_valid
    return out
