"""The stencil plan (``kernels.stencil_plan``) and the order the kernels walk.

On the lattice tables of the smoke's flagship pair (seed 0, at a reduced
point count: scale 0's blur table, scale 2's correlation tables) and on
random tables with absent taps, ids past the table and wide masks, the plan
holds its invariants: every present (vertex, tap) pair once in the
compacted lists, a stable permutation by presence mask, and the same
per-block tap counts for the negated-tap table under the forward's order.
A plain evaluation in the kernels' order (row blocks of the plan, only the
taps present in a block, 64-channel steps; each tap's compacted list cut
into the wrapper's chunks and the slabs summed in order) equals the plain
versions to float32 rounding, all-absent blocks and zero-count taps
included.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hplflownet_tpu_torch.kernels.dkernel import (stencil_dkernel_plain,
                                                  vertex_splits)
from hplflownet_tpu_torch.kernels.stencil import (apply_epilogue,
                                                  stencil_gather_matmul_plain)
from hplflownet_tpu_torch.kernels.stencil_plan import (ROW_BLOCK,
                                                       block_tap_counts,
                                                       make_stencil_plan,
                                                       make_stencil_plans,
                                                       presence)
from hplflownet_tpu_torch.lattice.offsets import tap_negation


@pytest.fixture(scope="module")
def lattice_tables():
    """Scale 0's blur table and scale 2's correlation tables of the seed-0
    flagship pair at 1024 points, with the tables' row counts."""
    saved = chip_smoke.NUM_POINTS, chip_smoke.CAPACITIES
    chip_smoke.NUM_POINTS = 1024
    chip_smoke.CAPACITIES = [4096, 6144, 3072, 1024, 512, 256, 128]
    try:
        scales = chip_smoke._lattice_case_tables(torch.device("cpu"))
    finally:
        chip_smoke.NUM_POINTS, chip_smoke.CAPACITIES = saved
    h0 = scales[0].pc1_splat_plan.start.shape[0]
    h2 = scales[2].pc1_splat_plan.start.shape[0]
    return {"scale-0 blur": (scales[0].pc1_blur_neighbors, h0),
            "scale-2 corr_self": (scales[2].pc1_corr_indices, h2),
            "scale-2 corr_cross": (scales[2].pc2_corr_uniq, h2)}


def _random_table(seed, f, h_out, h_in, absent=0.6, empty_rows=200,
                  empty_taps=(1,)):
    """ids in [-1, h_in + 8): ~``absent`` of them -1, some past the table;
    ``empty_rows`` rows with no tap at all, the taps ``empty_taps`` empty."""
    rng = np.random.RandomState(seed)
    nb = rng.randint(-1, h_in + 8, size=(f, h_out))
    nb[rng.rand(f, h_out) < absent] = -1
    nb[:, rng.choice(h_out, empty_rows, replace=False)] = -1
    for t in empty_taps:
        nb[t] = -1
    return torch.from_numpy(nb.astype(np.int32))


RANDOM = [pytest.param(0, 15, 700, 500, id="F15"),
          pytest.param(1, 65, 450, 300, id="F65-two-words"),
          pytest.param(2, 130, 300, 200, id="F130-three-words")]


def _tables(lattice_tables, seed, f, h_out, h_in):
    if seed is None:
        return lattice_tables
    return {"random": (_random_table(seed, f, h_out, h_in), h_in)}


def _check_plan(nb, h_in):
    plan = make_stencil_plan(nb, h_in)
    present = presence(nb, h_in)
    f, h = nb.shape
    # counts, and every present (vertex, tap) pair exactly once, in order
    assert torch.equal(plan.counts, ((nb >= 0) & (nb < h_in)).sum(1).int())
    for t in range(f):
        n = int(plan.counts[t])
        want = torch.nonzero(present[t]).flatten().int()
        assert torch.equal(plan.verts[t, :n], want)
        assert torch.equal(plan.rows[t, :n], nb[t, want.long()])
        assert bool((plan.verts[t, n:] == -1).all())
        assert bool((plan.rows[t, n:] == -1).all())
    # a permutation, sorted by the mask as an integer, stable on ties
    order = plan.order.long()
    assert plan.order.dtype == torch.int32
    assert torch.equal(torch.sort(order).values, torch.arange(h))
    masks = [sum(1 << t for t in range(f) if present[t, v]) for v in range(h)]
    keyed = [(masks[v], v) for v in order.tolist()]
    assert keyed == sorted(keyed)
    lean = make_stencil_plan(nb, h_in, lists=False)
    assert torch.equal(lean.order, plan.order) and lean.verts is None
    return plan, present


@pytest.mark.parametrize("seed,f,h_out,h_in",
                         [pytest.param(None, 0, 0, 0, id="lattice")] + RANDOM)
def test_plan_lists_and_row_order(lattice_tables, seed, f, h_out, h_in):
    for name, (nb, h) in _tables(lattice_tables, seed, f, h_out, h_in).items():
        _check_plan(nb, h)


def test_plan_groups_absent_taps_on_the_lattice(lattice_tables):
    """Sorting by mask lowers the share of tap-rows a block-skipping kernel
    computes, and the 15-tap tables' negated form keeps every block's count
    of present taps under the forward's order."""
    neg = torch.tensor(tap_negation(1, 3))
    for name, (nb, h) in lattice_tables.items():
        present = presence(nb, h)
        order = make_stencil_plan(nb, h, lists=False).order
        f, hh = nb.shape
        natural = block_tap_counts(present, torch.arange(hh, dtype=torch.int32))
        sorted_ = block_tap_counts(present, order)
        assert int(sorted_.sum()) <= int(natural.sum()), name
        assert int(sorted_.sum()) * ROW_BLOCK >= int(present.sum()), name
        if f == 15:
            negated = block_tap_counts(presence(nb[neg], h), order)
            assert torch.equal(negated, sorted_), name


def _plan_order_forward(table, nb, w, bias, slope, order):
    """Kernel 1's traversal: blocks of ROW_BLOCK rows in ``order``, the taps
    present in the block, 64-channel steps; rows past the table absent."""
    h_in, c_in = table.shape
    f, h_out = nb.shape
    out = torch.empty(h_out, w.shape[2])
    t32, w32 = table.float(), w.float()
    for b0 in range(0, h_out, ROW_BLOCK):
        rows = order[b0:b0 + ROW_BLOCK].long()
        acc = torch.zeros(len(rows), w.shape[2])
        for t in range(f):
            ids = nb[t, rows].long()
            ok = (ids >= 0) & (ids < h_in)
            if not bool(ok.any()):
                continue
            a = torch.where(ok[:, None], t32[ids.clamp(0, h_in - 1)], 0.0)
            for k0 in range(0, c_in, 64):
                acc += a[:, k0:k0 + 64] @ w32[t, k0:k0 + 64]
        out[rows] = apply_epilogue(acc, bias, slope, torch.float32)
    return out


def _plan_order_dkernel(table, g, plan, chunk):
    """Kernel 3's sums: each tap's compacted list in chunks of ``chunk``
    entries, 64 at a time, the chunks' slabs summed in order."""
    f = plan.counts.shape[0]
    t32, g32 = table.float(), g.float()
    out = torch.zeros(f, table.shape[1], g.shape[1])
    for t in range(f):
        n = int(plan.counts[t])
        slabs = []
        for c0 in range(0, max(n, 1), chunk):
            acc = torch.zeros(table.shape[1], g.shape[1])
            for e0 in range(c0, min(n, c0 + chunk), 64):
                e1 = min(n, e0 + 64)
                acc += (t32[plan.rows[t, e0:e1].long()].t()
                        @ g32[plan.verts[t, e0:e1].long()])
            slabs.append(acc)
        for s in slabs:
            out[t] += s
    return out


def _sanitised(nb, h_in):
    return torch.where(presence(nb, h_in), nb, -1)


@pytest.mark.parametrize("seed,f,h_out,h_in", RANDOM[:2])
def test_plan_order_evaluation_equals_the_plain_versions(seed, f, h_out, h_in):
    nb = _random_table(seed, f, h_out, h_in, empty_rows=300 if f < 60 else 200)
    plan = make_stencil_plan(nb, h_in)
    rng = np.random.RandomState(seed + 10)
    c_in, c_out = 100, 40
    table = torch.from_numpy(rng.randn(h_in, c_in).astype(np.float32))
    w = torch.from_numpy((rng.randn(f, c_in, c_out) * 0.1).astype(np.float32))
    bias = torch.from_numpy(rng.randn(c_out).astype(np.float32))
    g = torch.from_numpy(rng.randn(h_out, c_out).astype(np.float32))
    clean = _sanitised(nb, h_in)
    # blocks that hold no present tap (unoccupied rows sort to the front)
    counts = block_tap_counts(presence(nb, h_in), plan.order)
    assert int(counts[0]) == 0
    got = _plan_order_forward(table, nb, w, bias, 0.1, plan.order)
    want = stencil_gather_matmul_plain(table, clean, w, bias, 0.1)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    empty = plan.order[:ROW_BLOCK].long()
    torch.testing.assert_close(got[empty], apply_epilogue(
        torch.zeros(ROW_BLOCK, c_out), bias, 0.1, torch.float32).expand(
        ROW_BLOCK, c_out), rtol=0, atol=0)
    # the weight gradient, with the wrapper's chunking; tap 1 is empty
    _, chunk = vertex_splits(f, c_in, c_out, h_out)
    for ch in (chunk, 64):
        dw = _plan_order_dkernel(table, g, plan, ch)
        torch.testing.assert_close(dw, stencil_dkernel_plain(table, clean, g),
                                   rtol=1e-5, atol=1e-4)
        assert int(plan.counts[1]) == 0 and not bool(dw[1].any())


def test_plans_made_together_equal_plans_made_one_by_one(lattice_tables):
    """A pair's plans come from one sort per tap count; each equals the
    plan of its table alone, and its lists are column slices sharing the
    group's row stride."""
    tables = list(lattice_tables.values()) + [
        (_random_table(3, 15, 300, 200), 200), (_random_table(4, 65, 200, 150), 150)]
    for lists in (True, False):
        together = make_stencil_plans(tables, lists)
        for (nb, h), plan in zip(tables, together):
            alone = make_stencil_plan(nb, h, lists)
            for a, b in zip(plan, alone):
                assert (a is None and b is None) or torch.equal(a, b)
            if lists:
                assert plan.verts.stride() == plan.rows.stride()
                assert plan.verts.stride(1) == 1
