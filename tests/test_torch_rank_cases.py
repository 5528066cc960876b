"""The edge-case streams of ``hplflownet_tpu_torch.tools.rank_cases``.

Each case of the fused rank-mode reduction (kernel 5, ``blocked_rank_reduce``)
and of the block partial sums (kernel 7, ``rank_partial``) is checked for
the property it is named for.  On the CPU the wrappers run their plain
versions, which are held, in float32 at atol 1e-4 + rtol 1e-5:

* kernel 5's against a numpy float64 reference on every case, against the
  JAX package's ``blocked_rank_reduce`` (interpret mode, a window that
  covers the padded stream) where JAX's preconditions hold (ranks monotone,
  each 128-entry chunk within two aligned 128-rank blocks), and against
  ``rank_reduce`` on the same runs where the stream is a rank-mode plan;
* kernel 7's against the JAX package's ``blocked_rank_partial`` (interpret
  mode), whose one-hot form takes every case;
* kernel 2's (``rank_reduce``) against a numpy float64 reference on every
  case and, where the case is a plan over target ids, against the JAX
  package on the same plan (rebuilt from the ids): ``segment._wr_forward``
  in ``exact_mode()`` and ``blocked_rank_partial`` (interpret mode) +
  ``segment._combine`` with R >= 1, ``apply_reduce_plan`` with R = 0, and
  against kernel 5's plain version on the same stream.

The ``cuda``-marked test in ``tests/test_torch_kernels.py`` runs the same
cases through the CUDA kernels on a card.
"""

import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hplflownet_tpu.ops import segment as jseg
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu.ops.pallas_stencil import (blocked_rank_partial,
                                               blocked_rank_reduce as jax_brr)
from hplflownet_tpu_torch.kernels import rank_fused, rank_partial as rp_mod
from hplflownet_tpu_torch.kernels.rank_fused import (RANKS, STAGE_ROWS,
                                                     blocked_rank_reduce)
from hplflownet_tpu_torch.kernels.rank_partial import BLOCK, rank_partial
from hplflownet_tpu_torch.kernels.splat import rank_reduce
from hplflownet_tpu_torch.tools.rank_cases import (NO_RANK,
                                                   fused_args_from_runs,
                                                   fused_cases, partial_cases,
                                                   reduce_cases, to_torch)

FUSED = ["long_run", "empty_block", "decreasing", "outside", "c1_r0",
         "c1_r1", "c3_r2", "c68_r3", "c1024_r4"]
PARTIAL = ["lrank_ge_128", "lane_ge_r", "c1_r0", "c1_r1", "c3_r2", "c68_r3",
           "c1024_r4"]
REDUCE = ["long_run", "empty_runs", "c3_r2", "c5_r0", "c68_r3", "c64_r0",
          "c1024_r4", "c1100_r1", "clamped", "rid_outside"]
TOL = dict(atol=1e-4, rtol=1e-5)
CSRC = Path(rank_fused.__file__).resolve().parent.parent / "csrc"


@pytest.fixture(scope="module")
def fcases():
    return {c.name: c for c in fused_cases()}


@pytest.fixture(scope="module")
def pcases():
    return {c.name: c for c in partial_cases()}


@pytest.fixture(scope="module")
def rcases():
    return {c.name: c for c in reduce_cases()}


def _ranks(case):
    meta = case.meta.astype(np.int64)
    return (meta >> 2) if case.r else meta


def _block_ranges(case):
    m, sr = case.g.shape[0], case.start_rows.astype(np.int64)
    lo = np.clip(sr, 0, m)
    hi = np.maximum(np.clip(np.append(sr[1:], m), 0, m), lo)
    return lo, hi


def _fused_property(case):
    """What the case is named for."""
    rank = _ranks(case)
    lo, hi = _block_ranges(case)
    pitch = case.c + case.r
    if case.name == "long_run":
        assert int((case.end - case.start).max()) > STAGE_ROWS
        assert (rank[-20:] == NO_RANK).all()              # id -1 entries last
    elif case.name == "empty_block":
        assert lo[1] == hi[1] and not ((rank >= RANKS) & (rank < 2 * RANKS)).any()
    elif case.name == "decreasing":
        seg = rank[lo[1]:hi[1]]
        assert (np.diff(seg) < 0).any() and not case.rank_mode
    elif case.name == "outside":
        blk = rank // RANKS
        pos = np.arange(rank.shape[0])
        real = rank < case.t
        own = (pos >= lo[np.clip(blk, 0, len(lo) - 1)]) & (pos < hi[np.clip(blk, 0, len(lo) - 1)])
        assert (real & ~own).any()                        # outside their range
        assert (rank[:-1] == NO_RANK).any()               # id -1 mid-stream
    elif case.name in ("c1_r0", "c1_r1"):
        assert case.c == 1 and case.r == int(case.name[-1])
    elif case.name == "c3_r2":
        assert (case.c, case.r) == (3, 2)
        assert (2 * pitch) % 16 and (4 * pitch) % 16     # no 16-byte pitch
    elif case.name == "c68_r3":
        assert case.r == 3 and ((case.meta & 3) == 3).any()   # lane >= R
    elif case.name == "c1024_r4":
        assert (case.c, case.r) == (1024, 4) and (2 * pitch) % 16


def _numpy_fused(case):
    """Float64 sums of float32 products, by rank, of the entries in their
    block's stream range (lanes >= R add nothing)."""
    g, c, r = case.g, case.c, case.r
    lo, hi = _block_ranges(case)
    out = np.zeros((len(lo) * RANKS, c + int(case.with_weights)))
    for b in range(len(lo)):
        for j in range(lo[b], hi[b]):
            mj = int(case.meta[j])
            rank = mj >> 2 if r else mj
            if rank < 0 or rank // RANKS != b:
                continue
            if r:
                lane = mj & 3
                if lane >= r:
                    continue
                w = g[j, c + lane]
                out[rank, :c] += g[j, :c] * w                 # float32 product
                if case.with_weights:
                    out[rank, c] += w
            else:
                out[rank, :c] += g[j, :c]
    return out


def _jax_preconditions(case):
    """Ranks monotone along the stream and every 128-entry chunk inside two
    aligned 128-rank blocks: what JAX's windowed one-hot kernel takes."""
    rank = _ranks(case)
    if (np.diff(rank) < 0).any():
        return False
    for j0 in range(0, rank.shape[0], 128):
        chunk = rank[j0:j0 + 128]
        chunk = chunk[chunk != NO_RANK]
        if chunk.size and chunk.max() // RANKS - chunk[0] // RANKS > 1:
            return False
    return True


def test_the_cases_span_the_widths_and_lanes_the_kernels_take(fcases, pcases,
                                                             rcases):
    assert list(fcases) == FUSED and list(pcases) == PARTIAL
    assert list(rcases) == REDUCE
    for cases in (fcases.values(), pcases.values(), rcases.values()):
        assert {c.r for c in cases} == {0, 1, 2, 3, 4}
        assert {1, 68, 1024} <= {c.c for c in cases}
    assert all(c.g.shape[0] % BLOCK for c in pcases.values())
    assert sum(_jax_preconditions(c) for c in fcases.values()) == 6


def test_exported_stage_and_block_match_the_cuda_sources():
    src5 = (CSRC / "blocked_rank_reduce.cu").read_text()
    src7 = (CSRC / "rank_partial.cu").read_text()
    assert int(re.search(r"constexpr int STAGE = (\d+);", src5)[1]) == STAGE_ROWS
    assert int(re.search(r"constexpr int RANKS = (\d+);", src5)[1]) == RANKS
    assert int(re.search(r"constexpr int BLOCK = (\d+);", src7)[1]) == rp_mod.BLOCK


@pytest.mark.parametrize("name", FUSED)
def test_fused_edge_case_plain_matches_numpy_and_jax(name, fcases):
    case = fcases[name]
    _fused_property(case)
    a = to_torch(case)
    got = blocked_rank_reduce(a["g"], a["meta"], a["start_rows"], case.c,
                              case.r, case.with_weights).numpy()
    np.testing.assert_allclose(got, _numpy_fused(case), **TOL)
    if _jax_preconditions(case):
        m = case.g.shape[0]
        window = -(-m // 128) * 128
        want = np.asarray(jax.jit(lambda g, mt, sr: jax_brr(
            g, mt, sr, case.c, case.r, case.with_weights, window=window,
            interpret=True))(case.g, case.meta, case.start_rows))
        np.testing.assert_allclose(got, want[:got.shape[0]], **TOL)
    if case.rank_mode:
        runs = rank_reduce(a["g"], a.get("rid"), a["start"], a["end"], case.c,
                           case.with_weights)
        np.testing.assert_allclose(got[:case.t], runs.numpy(), **TOL)
        assert not got[case.t:].any()


def _partial_property(case):
    lrank = case.meta & 0xFFFF
    lane = case.meta >> 16
    pitch = case.c + case.r
    if case.name == "lrank_ge_128":
        assert (lrank >= BLOCK).any()
        assert (np.diff(lrank[:BLOCK].astype(np.int64)) < 0).any()  # shuffled
    elif case.name == "lane_ge_r":
        assert (lane >= case.r).any() and (lane < 0).any()
    elif case.name == "c3_r2":
        assert (case.c, case.r) == (3, 2) and (2 * pitch) % 16 and (4 * pitch) % 16
    elif case.name == "c68_r3":
        assert case.r == 3 and (lane == 3).any()
    elif case.name == "c1024_r4":
        assert (case.c, case.r) == (1024, 4) and (2 * pitch) % 16
    else:
        assert case.c == 1 and case.r == int(case.name[-1])


@pytest.mark.parametrize("name", PARTIAL)
def test_partial_edge_case_plain_matches_jax(name, pcases):
    case = pcases[name]
    _partial_property(case)
    a = to_torch(case)
    got = rank_partial(a["g"], a["meta"], case.c, case.r,
                       case.with_weights).numpy()
    want = np.asarray(jax.jit(lambda g, mt: blocked_rank_partial(
        g, mt, case.c, case.r, case.with_weights, interpret=True))(
            case.g, case.meta))
    m_pad = -(-case.g.shape[0] // BLOCK) * BLOCK
    assert got.shape == (m_pad, case.c + int(case.with_weights))
    np.testing.assert_allclose(got, want[:m_pad], **TOL)
    half = rank_partial(a["g"], a["meta"], case.c, case.r, case.with_weights,
                        out_dtype=torch.bfloat16)
    torch.testing.assert_close(half, torch.from_numpy(got).to(torch.bfloat16))


def _reduce_property(case):
    """What kernel 2's case is named for."""
    m, t = case.g.shape[0], case.start.shape[0]
    runs = case.end.astype(np.int64) - case.start
    pitch = case.c + case.r
    assert (case.ids is None) == (case.meta is None)
    if case.name == "long_run":
        assert runs.max() >= 1000 and (case.ids == -1).any()
    elif case.name == "empty_runs":
        assert (runs == 0).sum() > t // 2 and (case.c, case.r) == (1, 1)
    elif case.name in ("c3_r2", "c5_r0"):
        assert pitch == 5
    elif case.name in ("c68_r3", "c64_r0", "c1024_r4"):
        assert not case.with_weights and pitch in (71, 64, 1028)
    elif case.name == "c1100_r1":
        assert pitch % 2 and case.with_weights and case.c > 32 * 8 * 4
    elif case.name == "clamped":
        assert (case.start < 0).any() and (case.end > m).any()
        assert (case.end < case.start).any() and case.meta is None
    elif case.name == "rid_outside":
        assert (case.rid < 0).any() and (case.rid >= case.r).any()


def _numpy_reduce(case):
    """Float64 sums of float32 products over each clamped run; a lane id
    outside [0, R) adds nothing (not even to the density)."""
    g, c, r, m = case.g, case.c, case.r, case.g.shape[0]
    out = np.zeros((case.start.shape[0], c + int(case.with_weights)))
    for t, (s, e) in enumerate(zip(case.start, case.end)):
        for j in range(max(int(s), 0), min(int(e), m)):
            if not r:
                out[t] += g[j, :c]
                continue
            k = int(case.rid[j])
            if not 0 <= k < r:
                continue
            w = g[j, c + k]
            out[t, :c] += g[j, :c] * w                     # float32 product
            if case.with_weights:
                out[t, c] += w
    return out


@pytest.mark.parametrize("name", REDUCE)
def test_reduce_edge_case_plain_matches_numpy_and_jax(name, rcases):
    case = rcases[name]
    _reduce_property(case)
    a = to_torch(case)
    rid = a.get("rid")
    got = rank_reduce(a["g"], rid, a["start"], a["end"], case.c,
                      case.with_weights).numpy()
    np.testing.assert_allclose(got, _numpy_reduce(case), **TOL)
    if case.ids is None:
        return
    t, m, c, r = case.start.shape[0], case.g.shape[0], case.c, case.r
    plan = jseg.make_reduce_plan(jnp.asarray(case.ids), t)
    assert np.array_equal(np.asarray(plan.start), case.start)
    assert np.array_equal(np.asarray(plan.end), case.end)
    if r:
        rows, weights = case.src[:, :c], case.src[:, c:]
        assert np.array_equal(np.asarray(plan.perm) % r, case.rid)
        with exact_mode():
            want = jax.jit(lambda p, x, w: jseg._wr_forward(
                case.with_weights, p, x, w))(plan, rows, weights)
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        meta = np.asarray(plan.lrank) | (case.rid << 16)
        partial = jax.jit(lambda gg, mm: blocked_rank_partial(
            gg, mm, c, r, case.with_weights, interpret=True))(case.g, meta)
        want = np.asarray(jseg._combine(plan, partial, m))
    else:
        want = np.asarray(jax.jit(jseg.apply_reduce_plan)(plan, case.src))
    np.testing.assert_allclose(got, want, **TOL)
    # kernel 5's plain version on the same stream, and the same stream
    # derived from the runs alone
    fused = blocked_rank_reduce(a["g"], a["meta"], a["start_rows"], c, r,
                                case.with_weights)
    np.testing.assert_allclose(got, fused[:t].numpy(), **TOL)
    derived = fused_args_from_runs(rid, a["start"], a["end"], m)
    assert torch.equal(derived[0], a["meta"])
    assert torch.equal(derived[1], a["start_rows"])
