"""Edge-case streams for the segmented-sum kernels, made from a seed.

:func:`fused_cases` gives ``blocked_rank_reduce``'s (kernel 5) inputs,
:func:`partial_cases` ``rank_partial``'s (kernel 7) and
:func:`reduce_cases` ``rank_reduce``'s (kernel 2), each a list of
:class:`FusedCase` / :class:`PartialCase` / :class:`ReduceCase` with
float32 numpy arrays; the tests hold the plain versions against numpy and
the JAX package on them (on the CPU) and ``chip_smoke.py`` holds the
kernels against the plain versions (on the card) with :func:`to_torch`.

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

Kernel 2's cases are sorted plans over seeded target ids (``ids``, the
stream ``g = src[perm // R]`` and ``rid = perm % R`` as the splat gathers
them, or ``src[perm]`` with R = 0), so the JAX package can rebuild the same
plan, plus two streams no plan gives:

* ``long_run``: one target with 1000 entries among short runs, id -1
  entries (after every run);
* ``empty_runs``: two targets in three have no entry; one channel, R 1;
* ``c3_r2``, ``c5_r0``: pitches of 5 elements (10 / 20 bytes);
* ``c68_r3``, ``c64_r0``: the splat's and the ``gather_rows`` adjoint's
  widths, no density;
* ``c1024_r4``: the slice adjoint's width (2056-byte bf16 rows);
* ``c1100_r1``: an odd pitch wider than one pass of the kernel's lanes,
  with densities;
* ``clamped`` (no plan): runs with ``start < 0``, ``end > M`` and
  ``end < start``;
* ``rid_outside`` (no plan): lanes -1 and >= R on some entries (weight 0,
  no density).

A plan's runs tile the stream in target order, so kernel 5 takes the same
stream (``meta``, ``start_rows``) and must give the same bits.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..kernels.rank_fused import RANKS, STAGE_ROWS
from ..kernels.rank_partial import BLOCK

__all__ = ["FusedCase", "PartialCase", "ReduceCase", "fused_cases",
           "partial_cases", "reduce_cases", "fused_args_from_runs",
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


@dataclass
class ReduceCase:
    name: str
    g: np.ndarray              # (M, C + R) float32 stream
    rid: np.ndarray | None     # (M,) int32 lane per entry (None: R = 0)
    start: np.ndarray          # (T,) int32 run starts
    end: np.ndarray            # (T,) int32 run ends
    c: int
    r: int
    with_weights: bool
    ids: np.ndarray | None = None     # (M,) int32 target ids of the plan
    src: np.ndarray | None = None     # (M / R, C + R) rows | weights, or
                                      # (M, C) values (R = 0)
    meta: np.ndarray | None = None    # kernel 5's stream (plans only)
    start_rows: np.ndarray | None = None


def _fused_args(rank, rid, start, m):
    """Kernel 5's metas and block start rows for a plan's sorted ranks."""
    rank = np.where(rank >= 0, rank, NO_RANK).astype(np.int64)
    meta = ((rank << 2) | rid) if rid is not None else rank
    t = start.shape[0]
    tp = -(-t // RANKS) * RANKS
    start_rows = np.concatenate([start, np.full(tp - t, m)])[::RANKS]
    return meta.astype(np.int32), start_rows.astype(np.int32)


def _plan_case(rng, name, ids, t, c, r, with_w):
    """A sorted plan over target ids (``make_reduce_plan``'s: a stable
    sort, id -1 last) and the stream the splat (R >= 1) or
    ``apply_reduce_plan`` (R = 0) gathers through it."""
    flat = ids.reshape(-1).astype(np.int32)
    key = np.where(flat < 0, np.iinfo(np.int32).max, flat)
    perm = np.argsort(key, kind="stable")
    sk = key[perm]
    start = np.searchsorted(sk, np.arange(t), "left").astype(np.int32)
    end = np.searchsorted(sk, np.arange(t), "right").astype(np.int32)
    m = flat.shape[0]
    if r:
        src = _stream(rng, m // r, c, r)
        g, rid = src[perm // r], (perm % r).astype(np.int32)
    else:
        src = rng.randn(m, c).astype(np.float32)
        g, rid = src[perm], None
    meta, start_rows = _fused_args(flat[perm], rid, start, m)
    return ReduceCase(name, g, rid, start, end, c, r, with_w, flat, src,
                      meta, start_rows)


def _ids(rng, n, r, t, absent=0.1):
    ids = rng.randint(0, t, (n, r) if r else n)
    return np.where(rng.rand(*ids.shape) < absent, -1, ids).astype(np.int32)


def reduce_cases(seed: int = 0) -> list:
    """Kernel 2's edge cases (see the module's note)."""
    rng = np.random.RandomState(seed + 2)
    out = []
    ids = _ids(rng, 500, 4, 160)
    ids[:250] = 7                                        # 1000 entries
    out.append(_plan_case(rng, "long_run", ids, 160, 68, 4, True))
    out.append(_plan_case(rng, "empty_runs", 3 * _ids(rng, 300, 1, 300, 0.0),
                          900, 1, 1, True))
    out.append(_plan_case(rng, "c3_r2", _ids(rng, 400, 2, 200), 200, 3, 2,
                          True))
    out.append(_plan_case(rng, "c5_r0", _ids(rng, 600, 0, 200), 200, 5, 0,
                          False))
    out.append(_plan_case(rng, "c68_r3", _ids(rng, 300, 3, 100), 100, 68, 3,
                          False))
    out.append(_plan_case(rng, "c64_r0", _ids(rng, 900, 0, 300), 300, 64, 0,
                          False))
    out.append(_plan_case(rng, "c1024_r4", _ids(rng, 100, 4, 150), 150, 1024,
                          4, False))
    out.append(_plan_case(rng, "c1100_r1", _ids(rng, 200, 1, 120), 120, 1100,
                          1, True))
    m, t = 700, 200
    start = rng.randint(-50, m + 50, t)
    end = start + rng.randint(-5, 40, t)
    out.append(ReduceCase("clamped", _stream(rng, m, 68, 4),
                          rng.randint(0, 4, m).astype(np.int32),
                          start.astype(np.int32), end.astype(np.int32), 68, 4,
                          True))
    base = _plan_case(rng, "rid_outside", _ids(rng, 200, 4, 90), 90, 68, 4,
                      True)
    rid = base.rid.copy()
    hit = rng.rand(rid.shape[0]) < 0.15
    rid[hit] = rng.choice([-1, 4, 7], int(hit.sum()))
    out.append(ReduceCase("rid_outside", base.g, rid, base.start, base.end,
                          68, 4, True))
    return out


def fused_args_from_runs(rid, start, end, m: int):
    """Kernel 5's ``(meta, start_rows)`` (tensors) for runs that tile
    stream rows [0, end[-1]) in target order, as a rank-mode plan's do
    (entries past the last run get rank ``NO_RANK``); None for other runs.
    Reads the runs back to the host."""
    t = start.shape[0]
    counts = (end - start).long()
    if t == 0 or int(start[0]) != 0 or bool((counts < 0).any()) or bool(
            (start[1:] != end[:-1]).any()) or int(end[-1]) > m:
        return None
    rank = torch.full((m,), NO_RANK, dtype=torch.int64, device=start.device)
    rank[:int(end[-1])] = torch.repeat_interleave(
        torch.arange(t, device=start.device), counts)
    meta = (rank << 2) | rid.long() if rid is not None else rank
    tp = -(-t // RANKS) * RANKS
    rows = torch.cat([start, start.new_full((tp - t,), m)])[::RANKS]
    return meta.to(torch.int32).contiguous(), rows.contiguous()


def to_torch(case, dtype=torch.float32, device="cpu") -> dict:
    """The case's arrays as tensors on ``device``: the stream in ``dtype``,
    int32 metas, start rows and run bounds."""
    out = {"g": torch.from_numpy(case.g).to(device=device, dtype=dtype)
           .contiguous()}
    for key in ("meta", "start_rows", "rid", "start", "end"):
        val = getattr(case, key, None)
        if val is not None:
            out[key] = torch.from_numpy(val).to(device)
    return out
