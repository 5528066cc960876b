"""The work counter against a hand-worked tiny lattice, and the roofline."""

import pytest
import torch

from flowbench import work
from flowbench.reference import lattice as ref_lattice
from flowbench.reference import model as ref_model

CFG = {"compute_dtype": "bfloat16", "accumulate_dtype": "float32"}


def test_one_simplex():
    # one point at the origin splats onto one simplex: 4 vertices, and in
    # the radius-1 stencil (15 taps) each vertex sees itself and the other
    # three (a difference of two corners of a simplex is a stencil offset)
    pts = torch.zeros(1, 3)
    sc = ref_lattice.build_pyramid([[1.0, 1, 1, 1]], [8], pts, pts.clone())[0]
    assert sc.cloud1.num_valid == 4
    assert int((sc.blur1 >= 0).sum()) == 16
    log = []
    ctx = ref_model._Ctx(None, log)
    x = torch.ones(8, 2)
    w = torch.ones(15, 2, 3)
    ref_model._stencil(ctx, x, sc.blur1, w, "blur", rows_in=4)
    ref_model._dense(ctx, torch.ones(8, 3), torch.ones(3, 5), 0.0, rows=4)
    ref_model._splat(ctx, torch.ones(1, 2), sc.cloud1, 8)
    got = work.stencil(log, CFG)
    assert got.flops == 2 * 16 * 2 * 3
    # table rows 4 x 2, weights 15 x 2 x 3 in bf16; indices 15 x 4; out 4 x 3 f32
    assert got.bytes == 2 * (4 * 2 + 15 * 2 * 3) + 4 * 15 * 4 + 4 * 4 * 3
    assert work.dense(log, CFG).flops == 2 * 4 * 3 * 5
    assert work.dense(log, CFG).bytes == 2 * (4 * 3 + 3 * 5) + 4 * 4 * 5
    assert work.model_flops(log) == 2 * 16 * 2 * 3 + 2 * 4 * 3 * 5 + 2 * 4 * 2
    assert work.stencil_dw(log, CFG).flops == got.flops


def test_two_far_simplices_and_the_correlation():
    pts = torch.tensor([[0.0, 0.0, 0.0], [40.0, 40.0, 40.0]])
    sc = ref_lattice.build_pyramid([[1.0, 1, 1, 1]], [8], pts, pts.clone())[0]
    assert int((sc.blur1 >= 0).sum()) == 32          # two apart: 2 x 16
    assert int((sc.corr1 >= 0).sum()) == 32
    # cross[f, c, v] is present where v + filt[f] + corr[c] is a corner of
    # v's simplex.  In step counts n in {0,1}^4 (not all ones), a corner
    # apart by the subset S is reached by n1 + n2 = 1_S (2^|S| ways) or
    # 1_S + 1 (2^(4-|S|) - 2 ways); v itself is S empty (15 ways) and the
    # other three corners are |S| = 1, 2, 3 away: 8 + 6 + 8
    ways = lambda s: 2 ** s + 2 ** (4 - s) - 2  # noqa: E731
    per_vertex = ways(0) + ways(1) + ways(2) + ways(3)
    assert per_vertex == 37
    assert sc.cross.shape == (15, 15, 8)
    assert int((sc.cross >= 0).sum()) == 2 * 4 * per_vertex


def test_roofline():
    share, by = work.roofline(work.Work(989e12, 1.0), 1.0, "bfloat16")
    assert share == pytest.approx(100.0) and by == "operations"
    share, by = work.roofline(work.Work(1.0, 3.35e12 / 2), 1.0, "bfloat16")
    assert share == pytest.approx(50.0) and by == "bytes"
