"""Edge-case streams for the two segmented-sum kernels, made from a seed.

:func:`fused_cases` gives ``blocked_rank_reduce``'s (kernel 5) inputs and
:func:`partial_cases` ``rank_partial``'s (kernel 7), each a list of
:class:`FusedCase` / :class:`PartialCase` with float32 numpy arrays; the
tests hold the plain versions against the JAX package on them (on the
CPU) and ``chip_smoke.py`` holds the kernels against the plain versions
(on the card) with :func:`to_torch`.

Kernel 5's cases, named for what they hold:

* ``long_run``: one rank with a run of ``3 * STAGE_ROWS + 7`` entries, more
  than the kernel's stage, and id -1 entries (the fused route's sentinel
  rank ``1 << 28``) at the end of the stream, as a rank-mode plan has them;
* ``empty_block``: a 128-rank block with no entries (ranks 128-255);
* ``decreasing``: block 1's stream range shuffled, so ranks decrease inside
  it and runs are not contiguous (not a rank-mode plan);
* ``outside``: entries moved to ranks of another block (outside their
  block's stream range) and id -1 entries in the middle of the stream;
* ``c1_r0``, ``c1_r1``: one channel, plain rows (R = 0) and one weight
  lane with densities;
* ``c3_r2``: three channels and two lanes, a pitch of 5 elements (10 bytes
  in bf16, 20 in float32: not a multiple of 16);
* ``c68_r3``: three lanes, with lane 3 (>= R, so it adds nothing) on some
  entries;
* ``c1024_r4``: the slice adjoint's width, C + R = 1028 (2056 bytes in
  bf16), with densities (a last slab that holds only the density).

Where the stream is a rank-mode plan (``FusedCase.rank_mode``), ``rid``,
``start`` and ``end`` give ``rank_reduce`` the same runs, which it must sum
to the same bits.

Kernel 7's cases: local ranks >= 128 (dropped) among shuffled local ranks,
lanes >= R and negative lanes (weight 0), one channel with plain rows, a
5-element pitch, C + R = 1028, and R = 1 and 3; M is not a multiple of 128.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.rank_fused import RANKS, STAGE_ROWS
from ..kernels.rank_partial import BLOCK

__all__ = ["FusedCase", "PartialCase", "fused_cases", "partial_cases",
           "to_torch", "NO_RANK"]

NO_RANK = 1 << 28          # the fused route's rank of an id -1 entry


@dataclass
class FusedCase:
    name: str
    g: np.ndarray              # (M, C + R) float32
    meta: np.ndarray           # (M,) int32: rank << 2 | lane, or the rank
    start_rows: np.ndarray     # (ceil(T / 128),) int32
    c: int
    r: int
    with_weights: bool
    t: int                     # ranks of the plan
    rank_mode: bool            # rid / start / end describe the same runs
    rid: np.ndarray | None = None     # (M,) int32 lane per entry (R >= 1)
    start: np.ndarray | None = None   # (T,) int32 run starts
    end: np.ndarray | None = None     # (T,) int32 run ends


@dataclass
class PartialCase:
    name: str
    g: np.ndarray              # (M, C + R) float32
    meta: np.ndarray           # (M,) int32: lrank | lane << 16
    c: int
    r: int
    with_weights: bool


def _stream(rng, m, c, r):
    """Channel values and (for R >= 1) barycentric-like weights in [0, 1)."""
    return np.concatenate([rng.randn(m, c), rng.rand(m, r)],
                          axis=1).astype(np.float32)


def _rank_mode(rng, name, counts, c, r, with_w, n_invalid=0, max_lane=None):
    """A rank-mode plan's stream: rank t's run of ``counts[t]`` entries in
    rank order, ``n_invalid`` id -1 entries last; lanes below ``max_lane``
    (default R)."""
    counts = np.asarray(counts, np.int64)
    t = counts.shape[0]
    ranks = np.repeat(np.arange(t), counts)
    m = ranks.shape[0] + n_invalid
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    end = (start + counts).astype(np.int32)
    grank = np.concatenate([ranks, np.full(n_invalid, NO_RANK)]).astype(np.int64)
    rid = rng.randint(0, max_lane or r, m).astype(np.int32) if r else None
    meta = ((grank << 2) | rid) if r else grank
    tp = -(-t // RANKS) * RANKS
    start_rows = np.concatenate([start, np.full(tp - t, m)])[::RANKS]
    return FusedCase(name, _stream(rng, m, c, r), meta.astype(np.int32),
                     start_rows.astype(np.int32), c, r, with_w, t, True, rid,
                     start, end)


def _counts(rng, t, lo=0, hi=8):
    return rng.randint(lo, hi, t)


def _reordered(case, name, order, meta=None):
    """The case with its stream entries in ``order`` (and new metas): no
    longer a rank-mode plan."""
    return FusedCase(name, case.g[order], case.meta[order] if meta is None
                     else meta, case.start_rows, case.c, case.r,
                     case.with_weights, case.t, False)


def fused_cases(seed: int = 0) -> list:
    """Kernel 5's edge cases (see the module's note)."""
    rng = np.random.RandomState(seed)
    out = []
    counts = _counts(rng, 300, 1, 12)
    counts[140] = 3 * STAGE_ROWS + 7
    out.append(_rank_mode(rng, "long_run", counts, 68, 4, True, n_invalid=20))
    counts = _counts(rng, 512)
    counts[RANKS:2 * RANKS] = 0
    out.append(_rank_mode(rng, "empty_block", counts, 68, 4, False))

    base = _rank_mode(rng, "decreasing", _counts(rng, 384, 1, 8), 68, 4, True)
    lo, hi = int(base.start_rows[1]), int(base.start_rows[2])
    order = np.arange(base.meta.shape[0])
    order[lo:hi] = lo + rng.permutation(hi - lo)
    out.append(_reordered(base, "decreasing", order))

    base = _rank_mode(rng, "outside", _counts(rng, 384, 1, 8), 68, 4, True)
    meta = base.meta.copy()
    m = meta.shape[0]
    moved = rng.choice(m, 24, replace=False)
    grank = meta >> 2
    grank[moved] = (grank[moved] + RANKS) % base.t        # another block
    sentinel = rng.choice(np.setdiff1d(np.arange(m), moved), 12, replace=False)
    grank[sentinel] = NO_RANK
    meta = ((grank.astype(np.int64) << 2) | (meta & 3)).astype(np.int32)
    out.append(_reordered(base, "outside", np.arange(m), meta))

    out.append(_rank_mode(rng, "c1_r0", _counts(rng, 260), 1, 0, False))
    out.append(_rank_mode(rng, "c1_r1", _counts(rng, 260), 1, 1, True))
    out.append(_rank_mode(rng, "c3_r2", _counts(rng, 260), 3, 2, True,
                          n_invalid=5))
    out.append(_rank_mode(rng, "c68_r3", _counts(rng, 200), 68, 3, True,
                          max_lane=4))
    out.append(_rank_mode(rng, "c1024_r4", _counts(rng, 256, 0, 3), 1024, 4,
                          True, n_invalid=3))
    return out


def _partial(rng, name, m, c, r, with_w, lane_lo=0, lane_hi=None,
             big_ranks=0, shuffle=False):
    """A block-sorted local-rank stream of M entries (the lab's), with
    ``big_ranks`` entries given local ranks >= 128 and lanes drawn from
    [lane_lo, lane_hi)."""
    nb = -(-m // BLOCK)
    lrank = np.sort(rng.randint(0, BLOCK, (nb, BLOCK)), axis=1).reshape(-1)[:m]
    if shuffle:
        lrank = np.concatenate([rng.permutation(b) for b in
                                np.split(lrank, np.arange(BLOCK, m, BLOCK))])
    if big_ranks:
        idx = rng.choice(m, big_ranks, replace=False)
        lrank[idx] = rng.randint(BLOCK, 0x10000, big_ranks)
    lane = rng.randint(lane_lo, lane_hi or max(r, 1), m) if r else np.zeros(m, np.int64)
    meta = (lrank.astype(np.int64) | (lane.astype(np.int64) << 16)).astype(np.int64)
    meta = ((meta + 2 ** 31) % 2 ** 32 - 2 ** 31).astype(np.int32)   # wrap to int32
    return PartialCase(name, _stream(rng, m, c, r), meta, c, r, with_w)


def partial_cases(seed: int = 0) -> list:
    """Kernel 7's edge cases (see the module's note)."""
    rng = np.random.RandomState(seed + 1)
    return [
        _partial(rng, "lrank_ge_128", 1000, 68, 4, True, big_ranks=40,
                 shuffle=True),
        _partial(rng, "lane_ge_r", 700, 68, 2, True, lane_lo=-1, lane_hi=4),
        _partial(rng, "c1_r0", 333, 1, 0, False),
        _partial(rng, "c1_r1", 333, 1, 1, True, lane_hi=2),
        _partial(rng, "c3_r2", 500, 3, 2, True),
        _partial(rng, "c68_r3", 450, 68, 3, False, lane_hi=4),
        _partial(rng, "c1024_r4", 300, 1024, 4, True),
    ]


def to_torch(case, dtype=torch.float32, device="cpu") -> dict:
    """The case's arrays as tensors on ``device``: the stream in ``dtype``,
    int32 metas, start rows and run bounds."""
    out = {"g": torch.from_numpy(case.g).to(device=device, dtype=dtype)
           .contiguous(),
           "meta": torch.from_numpy(case.meta).to(device)}
    for key in ("start_rows", "rid", "start", "end"):
        val = getattr(case, key, None)
        if val is not None:
            out[key] = torch.from_numpy(val).to(device)
    return out
