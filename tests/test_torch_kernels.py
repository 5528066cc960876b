"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those are held
against the Pallas kernels run in interpret mode, on the inputs of the
JAX suite's own cases (tests/test_pallas_stencil.py), in float32: the
forward stencil, the splat reduction (and its plain-row mode), the
stencil's weight gradient (``stencil_dkernel``), the per-tap-table
gather-sum, the fused rank-mode reduction (``blocked_rank_reduce``) and the
block partial sums (``rank_partial``); the row take against numpy.  A
``cuda``-marked test holds the CUDA kernels against the plain versions on a
card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.ops.pallas_stencil import (blocked_rank_partial,
                                               stencil_dkernel as pallas_dkernel,
                                               stencil_gather_matmul as pallas_stencil,
                                               stencil_tap_tables_sum as pallas_tts)
from hplflownet_tpu.ops.segment import (ReducePlan, _combine, _wr_rank_fused,
                                        local_ranks)
from hplflownet_tpu_torch.kernels import (dkernel, plain_kernels, rank_fused,
                                          rank_partial as rank_partial_mod,
                                          splat, stencil, take, tap_tables)
from hplflownet_tpu_torch.kernels.rank_fused import (blocked_rank_reduce,
                                                     blocked_rank_reduce_plain)
from hplflownet_tpu_torch.kernels.rank_partial import (rank_partial,
                                                       rank_partial_plain)
from hplflownet_tpu_torch.kernels.take import row_take, row_take_plain
from hplflownet_tpu_torch.kernels.dkernel import (stencil_dkernel,
                                                  stencil_dkernel_plain,
                                                  vertex_splits)
from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
from hplflownet_tpu_torch.kernels.stencil import (stencil_gather_matmul,
                                                  stencil_gather_matmul_plain)
from hplflownet_tpu_torch.kernels.stencil_plan import make_stencil_plan
from hplflownet_tpu_torch.kernels.tap_tables import (
    stencil_tap_tables_sum, stencil_tap_tables_sum_plain)


def _mk(rng, h, f, c, co, drift):
    """tests/test_pallas_stencil.py::_mk: monotone taps, 10% absent."""
    table = rng.randn(h, c).astype(np.float32)
    nb = np.stack([
        np.sort(np.clip(np.arange(h) + rng.randint(-drift, drift, h), 0, h - 1))
        for _ in range(f)]).astype(np.int32)
    nb = np.where(rng.rand(f, h) < 0.1, -1, nb).astype(np.int32)
    kern = (rng.randn(f, c, co) * 0.1).astype(np.float32)
    return table, nb, kern


# (seed, H, F, C_in, C_out, drift, epilogue) of test_pallas_stencil.py:36
# (tight spans), :89 (small table) and :98 (fused bias + leaky + bf16 cast)
STENCIL_CASES = [
    pytest.param(0, 3000, 15, 68, 64, 40, False, id="tight_spans"),
    pytest.param(2, 200, 15, 20, 16, 10, False, id="small_table"),
    pytest.param(3, 1500, 15, 36, 24, 30, True, id="fused_epilogue"),
]


@pytest.mark.parametrize("seed,h,f,c,co,drift,epilogue", STENCIL_CASES)
def test_stencil_plain_matches_pallas_interpret(seed, h, f, c, co, drift,
                                                epilogue):
    rng = np.random.RandomState(seed)
    table, nb, kern = _mk(rng, h, f, c, co, drift)
    kw, tkw = {}, {}
    if epilogue:
        bias = rng.randn(co).astype(np.float32)
        kw = dict(bias=bias, act_slope=0.1, out_dtype=jnp.bfloat16)
        tkw = dict(bias=torch.from_numpy(bias), act_slope=0.1,
                   out_dtype=torch.bfloat16)
    want = np.asarray(jax.jit(lambda t, n, k: pallas_stencil(
        t, n, k, interpret=True, **kw))(table, nb, kern)).astype(np.float32)
    got = stencil_gather_matmul(torch.from_numpy(table), torch.from_numpy(nb),
                                torch.from_numpy(kern), **tkw).float().numpy()
    if epilogue:
        # one bf16 ulp (2^-8 relative) where the float32 sums round apart
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=1e-3)
    else:
        # float32 sums of F * C_in products in another order
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_dkernel_plain_matches_pallas_interpret():
    """tests/test_pallas_stencil.py:115's case: dW through the windowed
    Pallas kernel (interpret mode) == the port's plain version."""
    rng = np.random.RandomState(4)
    table, nb, _ = _mk(rng, 2000, 15, 36, 0, drift=30)
    g = rng.randn(nb.shape[1], 24).astype(np.float32)
    want = np.asarray(jax.jit(lambda t, n, gg: pallas_dkernel(
        t, n, gg, interpret=True))(table, nb, g))
    got = stencil_dkernel(torch.from_numpy(table), torch.from_numpy(nb),
                          torch.from_numpy(g))
    assert got.dtype == torch.float32 and got.shape == (15, 36, 24)
    # float32 sums of up to 2000 products in another order
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


def _tap_tables_case():
    """tests/test_pallas_stencil.py:133's tables and neighbour rows."""
    rng = np.random.RandomState(5)
    f, h, hout, c = 10, 1800, 1500, 128
    tables = rng.randn(h, f * c).astype(np.float32)
    nb = np.stack([
        np.sort(np.clip(np.arange(hout) * h // hout
                        + rng.randint(-30, 30, hout), 0, h - 1))
        for _ in range(f)]).astype(np.int32)
    nb = np.where(rng.rand(f, hout) < 0.1, -1, nb).astype(np.int32)
    return tables, nb, c


def test_tap_tables_sum_plain_matches_pallas_interpret():
    tables, nb, c = _tap_tables_case()
    want = np.asarray(jax.jit(lambda t, n: pallas_tts(
        t, c, n, group=4, interpret=True))(tables, nb))
    got = stencil_tap_tables_sum(torch.from_numpy(tables), c,
                                 torch.from_numpy(nb))
    assert got.dtype == torch.float32 and got.shape == (nb.shape[1], c)
    # ten float32 terms per element, summed in tap order on both sides
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def test_dkernel_vertex_splits_cover_the_vertices_in_fixed_chunks():
    # the flagship's weight-gradient shapes (the decoder blurs at scales 0,
    # 1 and 2, the encoder blur, both correlations) and a tiny one: chunks
    # of whole 64-entry stages that cover a list of H_out entries
    for f, c_in, c_out, h in ((15, 580, 1024, 25600), (15, 324, 512, 31872),
                              (15, 388, 256, 12928), (15, 68, 64, 25600),
                              (15, 128, 32, 12928), (65, 64, 480, 12928),
                              (15, 20, 8, 100)):
        splits, chunk = vertex_splits(f, c_in, c_out, h)
        assert chunk % 64 == 0 and splits * chunk >= h > (splits - 1) * chunk
        assert vertex_splits(f, c_in, c_out, h) == (splits, chunk)
    assert vertex_splits(15, 580, 1024, 25600)[0] == 1    # 600 tiles: enough
    assert vertex_splits(15, 128, 32, 12928)[0] > 1       # 15 tiles: split
    # no chunk shorter than 4 stages
    assert vertex_splits(15, 128, 32, 12928)[1] >= 256


def _runs(same):
    """Run bounds of a sorted stream whose key changes where ~same."""
    run_id = np.cumsum(~same) - 1
    t = run_id[-1] + 1
    start = np.searchsorted(run_id, np.arange(t), "left").astype(np.int32)
    end = np.searchsorted(run_id, np.arange(t), "right").astype(np.int32)
    return run_id.astype(np.int32), start, end


@pytest.mark.parametrize("with_w", [False, True])
def test_rank_reduce_plain_matches_pallas_partial_plus_combine(with_w):
    """tests/test_pallas_stencil.py:174's stream through blocked_rank_partial
    (interpret mode) and segment._combine == the port's fused reduction."""
    rng = np.random.RandomState(6)
    n, c, r = 700, 20, 4
    m = n * r
    rows = rng.randn(n, c).astype(np.float32)
    weights = rng.rand(n, r).astype(np.float32)
    perm = rng.permutation(m).astype(np.int32)
    same = rng.rand(m) < 0.6
    same[0] = False
    lrank = np.asarray(local_ranks(jnp.asarray(same)))
    pid, rid = perm // r, (perm % r).astype(np.int32)
    g = np.concatenate([rows, weights], axis=1)[pid]

    meta = (lrank | (rid << 16)).astype(np.int32)
    partial = jax.jit(lambda gg, mm: blocked_rank_partial(
        gg, mm, c, r, with_w, interpret=True))(g, meta)
    run_id, start, end = _runs(same)
    plan = ReducePlan(ids=jnp.asarray(run_id), perm=jnp.arange(m, dtype=jnp.int32),
                      start=jnp.asarray(start), end=jnp.asarray(end),
                      lrank=jnp.asarray(lrank), r0=jnp.zeros((1,), jnp.int32))
    want = np.asarray(_combine(plan, partial, m))

    got = rank_reduce(torch.from_numpy(g), torch.from_numpy(rid),
                      torch.from_numpy(start), torch.from_numpy(end), c,
                      with_w).numpy()
    assert got.shape == want.shape == (len(start), c + int(with_w))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_rank_reduce_rounds_bf16_products_before_the_sum():
    rng = np.random.RandomState(7)
    m, c = 64, 5
    g = torch.from_numpy(rng.randn(m, c + 2).astype(np.float32)).to(torch.bfloat16)
    rid = torch.from_numpy(rng.randint(0, 2, m).astype(np.int32))
    start = torch.tensor([0, 10, 40], dtype=torch.int32)
    end = torch.tensor([10, 40, 64], dtype=torch.int32)
    got = rank_reduce_plain(g, rid, start, end, c, True)
    w = g.float()[torch.arange(m), c + rid.long()]
    prod = (g.float()[:, :c] * w[:, None]).to(torch.bfloat16).float()
    for t in range(3):
        s, e = int(start[t]), int(end[t])
        torch.testing.assert_close(got[t, :c], prod[s:e].double().sum(0).float())
        torch.testing.assert_close(got[t, c], w[s:e].double().sum().float())


def test_wrappers_run_plain_versions_on_cpu_and_count_no_launch():
    rng = np.random.RandomState(1)
    table, nb, kern = (torch.from_numpy(a) for a in _mk(rng, 50, 15, 8, 4, 5))
    wrappers = (stencil_gather_matmul, rank_reduce, stencil_dkernel,
                stencil_tap_tables_sum, blocked_rank_reduce, row_take,
                rank_partial)
    before = [w.launches for w in wrappers]
    out = stencil_gather_matmul(table, nb, kern)
    torch.testing.assert_close(out, stencil_gather_matmul_plain(table, nb, kern))
    g = torch.randn(20, 6)
    rid = torch.zeros(20, dtype=torch.int32)
    bounds = torch.tensor([0, 20], dtype=torch.int32)
    rank_reduce(g, rid, bounds[:1], bounds[1:], 5)
    cot = torch.randn(50, 4)
    torch.testing.assert_close(stencil_dkernel(table, nb, cot),
                               stencil_dkernel_plain(table, nb, cot))
    tabs = torch.randn(50, 15 * 3)
    torch.testing.assert_close(stencil_tap_tables_sum(tabs, 3, nb),
                               stencil_tap_tables_sum_plain(tabs, 3, nb))
    meta = torch.arange(20, dtype=torch.int32) << 2
    rows = torch.zeros(1, dtype=torch.int32)
    torch.testing.assert_close(blocked_rank_reduce(g, meta, rows, 5, 1),
                               blocked_rank_reduce_plain(g, meta, rows, 5, 1))
    idx = torch.tensor([3, 0, 49], dtype=torch.int32)
    torch.testing.assert_close(row_take(table, idx), row_take_plain(table, idx))
    torch.testing.assert_close(rank_partial(g, meta >> 2, 5, 1),
                               rank_partial_plain(g, meta >> 2, 5, 1))
    with plain_kernels():
        stencil_gather_matmul(table, nb, kern)
    assert [w.launches for w in wrappers] == before


def test_backward_runs_under_its_forwards_plain_setting_on_another_thread():
    """Autograd runs the backward of CUDA tensors on a thread of its own,
    which does not inherit ``plain_kernels()``: the decorated backward
    re-enters the setting its forward recorded."""
    import threading

    from hplflownet_tpu_torch.kernels import backward_like_forward, plain_forced
    seen = {}

    def bare(ctx, g):
        seen["bare"] = plain_forced()

    @backward_like_forward
    def decorated(ctx, g):
        seen["decorated"] = plain_forced()

    class Ctx:
        plain_kernels = True

    with plain_kernels():
        for fn in (bare, decorated):
            th = threading.Thread(target=fn, args=(Ctx, None))
            th.start()
            th.join(timeout=10)
            assert not th.is_alive()
    assert seen == {"bare": False, "decorated": True}
    assert plain_forced() is False


def test_argument_checks_reject_what_the_kernels_do_not_take():
    t = torch.zeros(10, 4)
    nb = torch.zeros(3, 5, dtype=torch.int32)
    w = torch.zeros(3, 4, 2)
    stencil._check_args(t, nb, w, None, torch.float32)
    with pytest.raises(TypeError):
        stencil._check_args(t.double(), nb, w.double(), None, torch.float32)
    with pytest.raises(TypeError):
        stencil._check_args(t, nb.long(), w, None, torch.float32)
    with pytest.raises(ValueError):
        stencil._check_args(t, nb, torch.zeros(3, 5, 2), None, torch.float32)
    with pytest.raises(ValueError):
        stencil._check_args(t.t(), torch.zeros(3, 5, dtype=torch.int32),
                            torch.zeros(3, 10, 2), None, torch.float32)
    g = torch.zeros(8, 6)
    rid = torch.zeros(8, dtype=torch.int32)
    se = torch.zeros(3, dtype=torch.int32)
    splat._check_args(g, rid, se, se, 4)
    with pytest.raises(ValueError):
        splat._check_args(g, rid, se, se, 6)
    with pytest.raises(TypeError):
        splat._check_args(g, rid.long(), se, se, 4)
    with pytest.raises(ValueError):
        splat._check_args(g, rid[:4], se, se, 4)
    gg = torch.zeros(5, 2)
    dkernel._check_args(t, nb, gg)
    with pytest.raises(TypeError):
        dkernel._check_args(t, nb, gg.to(torch.bfloat16))
    with pytest.raises(ValueError):
        dkernel._check_args(t, nb, torch.zeros(4, 2))
    with pytest.raises(ValueError):
        dkernel._check_args(t, nb, torch.zeros(2, 5).t())
    splat._check_args(g[:, :4].contiguous(), None, se, se, 4)
    with pytest.raises(ValueError):               # plain rows take no density
        splat._check_args(g[:, :4].contiguous(), None, se, se, 4, True)
    meta = torch.zeros(8, dtype=torch.int32)
    rows = torch.zeros(2, dtype=torch.int32)
    rank_fused._check_args(g, meta, rows, 4, 2, True)
    rank_fused._check_args(g, meta, rows, 6, 0, False)
    with pytest.raises(ValueError):
        rank_fused._check_args(g, meta, rows, 4, 1, False)    # C + R != 6
    with pytest.raises(ValueError):
        rank_fused._check_args(g, meta, rows, 6, 0, True)
    with pytest.raises(ValueError):
        rank_fused._check_args(torch.zeros(8, 10), meta, rows, 5, 5, False)
    with pytest.raises(TypeError):
        rank_fused._check_args(g, meta.long(), rows, 4, 2, False)
    with pytest.raises(ValueError):
        rank_fused._check_args(g, meta[:4], rows, 4, 2, False)
    take._check_args(t, torch.zeros(3, dtype=torch.int32))
    with pytest.raises(TypeError):
        take._check_args(t, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(TypeError):
        take._check_args(t.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError):
        take._check_args(t.t(), torch.zeros(3, dtype=torch.int32))
    rank_partial_mod._check_args(g, meta, 4, 2, True, 8, torch.bfloat16)
    with pytest.raises(ValueError):
        rank_partial_mod._check_args(g, meta, 4, 2, True, 0, torch.float32)
    with pytest.raises(TypeError):
        rank_partial_mod._check_args(g, meta, 4, 2, True, 8, torch.float16)
    with pytest.raises(ValueError):
        rank_partial_mod._check_args(g, meta, 6, 0, True, 8, torch.float32)
    tabs = torch.zeros(10, 3 * 4)
    tap_tables._check_args(tabs, 4, nb)
    with pytest.raises(ValueError):
        tap_tables._check_args(tabs, 3, nb)
    with pytest.raises(TypeError):
        tap_tables._check_args(tabs.double(), 4, nb)
    with pytest.raises(TypeError):
        tap_tables._check_args(tabs, 4, nb.long())


def _mk_rank_plan(rng, t, m_real, m):
    """tests/test_pallas_stencil.py::_mk_rank_plan: dense ranks with random
    run lengths over the first ``m_real`` entries, a sentinel tail."""
    ranks, cur = [], 0
    while len(ranks) < m_real and cur < t:
        ln = int(rng.randint(1, 7))
        ranks.extend([cur] * min(ln, m_real - len(ranks)))
        cur += 1
    nuniq = ranks[-1] + 1
    ranks = np.asarray(ranks + [nuniq - 1] * (m - len(ranks)), np.int32)
    valid = np.arange(m) < m_real
    same = np.concatenate([[False], ranks[1:] == ranks[:-1]])
    if m > m_real:
        same[m_real] = False
        same[m_real + 1:] = True
    lrank = np.asarray(local_ranks(jnp.asarray(same)))
    start = np.searchsorted(ranks[:m_real], np.arange(t)).astype(np.int32)
    end = np.searchsorted(ranks[:m_real], np.arange(t), "right").astype(np.int32)
    dead = np.arange(t) >= nuniq
    start = np.where(dead, m_real, start).astype(np.int32)
    end = np.where(dead, m_real, end).astype(np.int32)
    plan = ReducePlan(ids=jnp.asarray(np.where(valid, ranks, -1)),
                      perm=jnp.arange(m, dtype=jnp.int32),
                      start=jnp.asarray(start), end=jnp.asarray(end),
                      lrank=jnp.asarray(lrank), r0=jnp.asarray(ranks[::128]))
    return plan, ranks, valid


def _fused_args_jax_way(plan, rid, r):
    """The kernel's inputs as JAX's ``_wr_rank_fused`` builds them: global
    rank ``r0[j // 128] + lrank[j]``, ``start_rows = start[::128]`` padded
    with M."""
    m, t = np.asarray(plan.lrank).shape[0], np.asarray(plan.start).shape[0]
    grank = np.repeat(np.asarray(plan.r0), 128)[:m] + np.asarray(plan.lrank)
    meta = ((grank << 2) | rid) if r else grank
    tp = -(-t // 128) * 128
    start = np.concatenate([np.asarray(plan.start), np.full(tp - t, m)])
    return (torch.from_numpy(meta.astype(np.int32)),
            torch.from_numpy(start[::128].astype(np.int32)))


@pytest.mark.parametrize("mode", ["weights", "densities", "plain_rows"])
def test_blocked_rank_reduce_plain_matches_pallas_interpret(mode):
    """tests/test_pallas_stencil.py:259's case (R = 4 without and with
    densities, and R = 0) through ``_wr_rank_fused`` in interpret mode ==
    the port's plain version on the same stream, meta and start rows.
    (:292, the TPU window's counted degrade, has no counterpart here.)"""
    rng = np.random.RandomState(11)
    t, m_real, m, c, r = 640, 1500, 1600, 20, 4
    plan, _, valid = _mk_rank_plan(rng, t, m_real, m)
    g = rng.randn(m, c + r).astype(np.float32)
    g[~valid] = 0.0                       # JAX's rank-mode zero contract
    rid = rng.randint(0, r, m).astype(np.int32)
    if mode == "plain_rows":
        c, r, with_w = c + r, 0, False
    else:
        with_w = mode == "densities"
    want = np.asarray(jax.jit(lambda gg, rr: _wr_rank_fused(
        plan, gg, rr, c, r, with_w, interpret=True))(g, rid))
    meta, start_rows = _fused_args_jax_way(plan, rid, r)
    got = blocked_rank_reduce(torch.from_numpy(g), meta, start_rows, c, r,
                              with_w)
    assert got.shape == (start_rows.shape[0] * 128, c + int(with_w))
    np.testing.assert_allclose(got[:t].numpy(), want, atol=1e-4)
    assert not got[t:].any()


def test_blocked_rank_reduce_plain_matches_pallas_on_builder_plans():
    """tests/test_pallas_stencil.py:362's case: the fused kernel on the
    builder's real splat plans (the port's pyramid, table-identical to
    JAX's), in interpret mode and in the port's plain version."""
    from hplflownet_tpu_torch.lattice import LatticeSpec, ScaleSpec, build_pyramid
    rng = np.random.RandomState(7)
    n, c = 256, 12
    pc1 = rng.randn(n, 3).astype(np.float32) * 3.0
    pc2 = pc1 + 0.1 * rng.randn(n, 3).astype(np.float32)
    spec = LatticeSpec(d=3, scales=(ScaleSpec(1.0, 1, 1, 1, capacity=1024),
                                    ScaleSpec(0.5, 1, 1, 1, capacity=1024)))
    scales = build_pyramid(spec, torch.from_numpy(pc1), torch.from_numpy(pc2))
    for i, (plan, bary) in enumerate(
            (p, b) for sp in scales for p, b in (
                (sp.pc1_splat_plan, sp.pc1_barycentric),
                (sp.pc2_splat_plan, sp.pc2_barycentric))):
        with_w = i % 2 == 1
        jplan = ReducePlan(*[jnp.asarray(x.numpy()) for x in plan])
        weights = bary.numpy()
        r = weights.shape[1]
        rows = rng.randn(weights.shape[0], c).astype(np.float32)
        perm = plan.perm.numpy()
        rid = (perm % r).astype(np.int32)
        g = np.concatenate([rows, weights], axis=1)[perm // r]
        want = np.asarray(jax.jit(lambda gg, rr: _wr_rank_fused(
            jplan, gg, rr, c, r, with_w, interpret=True))(g, rid))
        meta, start_rows = _fused_args_jax_way(jplan, rid, r)
        got = blocked_rank_reduce(torch.from_numpy(g), meta, start_rows, c, r,
                                  with_w)[:want.shape[0]]
        np.testing.assert_allclose(got.numpy(), want, atol=2e-4)


def test_blocked_rank_reduce_ignores_entries_outside_their_block_range():
    """Entries whose rank lies outside their 128-rank block's stream range,
    and sentinel ranks, add nothing; ranks need not be contiguous runs."""
    g = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    meta = torch.tensor([0, 1, 0, 130, 1 << 28, 129], dtype=torch.int32)
    start_rows = torch.tensor([0, 3], dtype=torch.int32)
    out = blocked_rank_reduce(g, meta, start_rows, 2, 0)
    assert out.shape == (256, 2)
    torch.testing.assert_close(out[0], g[0] + g[2])
    torch.testing.assert_close(out[1], g[1])
    torch.testing.assert_close(out[129], g[5])
    torch.testing.assert_close(out[130], g[3])
    assert int((out.abs().sum(1) > 0).sum()) == 4


@pytest.mark.parametrize("with_w", [False, True])
def test_rank_partial_plain_matches_pallas_interpret(with_w):
    """tests/test_pallas_stencil.py:174's stream through
    ``blocked_rank_partial`` (interpret mode), the function of the lab's
    ``variant``, == the port's plain version; bf16 output rounds it."""
    rng = np.random.RandomState(6)
    n, c, r = 700, 20, 4
    m = n * r
    rows = rng.randn(n, c).astype(np.float32)
    weights = rng.rand(n, r).astype(np.float32)
    perm = rng.permutation(m).astype(np.int32)
    same = rng.rand(m) < 0.6
    same[0] = False
    lrank = np.asarray(local_ranks(jnp.asarray(same)))
    pid, rid = perm // r, perm % r
    g = np.concatenate([rows, weights], axis=1)[pid]
    meta = (lrank | (rid << 16)).astype(np.int32)
    want = np.asarray(jax.jit(lambda gg, mm: blocked_rank_partial(
        gg, mm, c, r, with_w, interpret=True))(g, meta))
    got = rank_partial(torch.from_numpy(g), torch.from_numpy(meta), c, r,
                       with_w, bo=16)
    m_pad = -(-m // 128) * 128
    assert got.shape == (m_pad, c + int(with_w)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want[:m_pad], atol=1e-4)
    assert not want[m_pad:].any()
    half = rank_partial(torch.from_numpy(g), torch.from_numpy(meta), c, r,
                        with_w, out_dtype=torch.bfloat16)
    assert half.dtype == torch.bfloat16
    torch.testing.assert_close(half, got.to(torch.bfloat16))
    # plain rows (R = 0): the partials of the stream itself
    want0 = np.asarray(jax.jit(lambda gg, mm: blocked_rank_partial(
        gg, mm, c + r, 0, interpret=True))(g, lrank.astype(np.int32)))
    got0 = rank_partial(torch.from_numpy(g), torch.from_numpy(lrank.astype(np.int32)),
                        c + r, 0)
    np.testing.assert_allclose(got0.numpy(), want0[:m_pad], atol=1e-4)


def test_row_take_plain_is_numpy_take():
    rng = np.random.RandomState(8)
    for dt in (torch.float32, torch.bfloat16):
        table = torch.from_numpy(rng.randn(301, 128).astype(np.float32)).to(dt)
        idx = rng.randint(0, 301, 300).astype(np.int32)
        got = row_take(table, torch.from_numpy(idx))
        want = np.take(table.float().numpy(), idx, axis=0)
        np.testing.assert_array_equal(got.float().numpy(), want)
    # out-of-range indices clamp to the nearest row
    out = row_take(table, torch.tensor([-5, 400], dtype=torch.int32))
    torch.testing.assert_close(out, table[[0, 300]])


def test_rank_reduce_plain_rows_mode_sums_unweighted_runs():
    """R = 0: ``rid`` None, g (M, C), no density; the JAX package's plain-row
    reduction (``apply_reduce_plan``'s) is the same run sum."""
    rng = np.random.RandomState(9)
    g = torch.from_numpy(rng.randn(40, 6).astype(np.float32))
    start = torch.tensor([0, 5, 5, 30], dtype=torch.int32)
    end = torch.tensor([5, 5, 30, 40], dtype=torch.int32)
    got = rank_reduce(g, None, start, end, 6)
    for t in range(4):
        s, e = int(start[t]), int(end[t])
        torch.testing.assert_close(got[t], g[s:e].double().sum(0).float())
    assert not got[1].any()
    with pytest.raises(ValueError):
        rank_reduce_plain(g, None, start, end, 6, True)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    rng = np.random.RandomState(0)
    dev = torch.device("cuda")
    # the stencil at C_out 64 (n64 tiles) and 200 (n128, ragged), with the
    # plan's row order, and bit for bit on a rerun
    for c_in, c_out in ((68, 64), (100, 200)):
        table, nb, kern = _mk(rng, 3000, 15, c_in, c_out, 40)
        n = torch.from_numpy(nb).to(dev)
        plan = make_stencil_plan(n, 3000)
        for dt in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(table).to(dev, dt)
            k = torch.from_numpy(kern).to(dev, dt)
            bias = torch.linspace(-1, 1, c_out, device=dev)
            got = stencil_gather_matmul(t, n, k, bias=bias, act_slope=0.1,
                                        plan=plan)
            assert torch.equal(got, stencil_gather_matmul(
                t, n, k, bias=bias, act_slope=0.1, plan=plan))
            want = stencil_gather_matmul_plain(t, n, k, bias=bias, act_slope=0.1)
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    g = torch.randn(4000, 72, device=dev)
    rid = torch.randint(0, 4, (4000,), device=dev, dtype=torch.int32)
    cuts = torch.sort(torch.randint(0, 4000, (999,), device=dev)).values
    start = torch.cat([torch.zeros(1, device=dev, dtype=torch.long), cuts]).int()
    end = torch.cat([cuts, torch.full((1,), 4000, device=dev)]).int()
    for dt in (torch.float32, torch.bfloat16):
        got = rank_reduce(g.to(dt), rid, start, end, 68, True)
        assert torch.equal(got, rank_reduce(g.to(dt), rid, start, end, 68, True))
        want = rank_reduce_plain(g.to(dt), rid, start, end, 68, True)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    # the weight gradient at a split (15 x 128 -> 32) and an unsplit shape
    for f, h, c_in, c_out in ((15, 3000, 128, 32), (15, 3000, 68, 200)):
        table, nb, _ = _mk(rng, h, f, c_in, 0, 40)
        cot = torch.randn(h, c_out, device=dev)
        n = torch.from_numpy(nb).to(dev)
        plan = make_stencil_plan(n, h)
        for dt in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(table).to(dev, dt)
            got = stencil_dkernel(t, n, cot.to(dt), plan)
            assert torch.equal(got, stencil_dkernel(t, n, cot.to(dt), plan))
            want = stencil_dkernel_plain(t, n, cot.to(dt))
            torch.testing.assert_close(got, want, rtol=1e-4,
                                       atol=1e-4 * float(want.abs().max()))
    tables, nb, c = _tap_tables_case()
    for dt in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(tables).to(dev, dt)
        n = torch.from_numpy(nb).to(dev)
        torch.testing.assert_close(stencil_tap_tables_sum(t, c, n),
                                   stencil_tap_tables_sum_plain(t, c, n),
                                   rtol=1e-6, atol=1e-5)
    # the plain-row mode, the fused rank reduction (bit-equal to rank_reduce
    # on the same runs), the row take and the block partials
    rank = torch.repeat_interleave(torch.arange(1000, device=dev),
                                   (end - start).long())
    lane = rid[:rank.shape[0]].contiguous()
    starts = torch.cat([start, torch.full((24,), rank.shape[0], device=dev,
                                          dtype=torch.int32)])[::128].contiguous()
    for dt in (torch.float32, torch.bfloat16):
        gd = g.to(dt)[:rank.shape[0]].contiguous()
        plain_rows = gd[:, :68].contiguous()
        torch.testing.assert_close(rank_reduce(plain_rows, None, start, end, 68),
                                   rank_reduce_plain(plain_rows, None, start, end, 68),
                                   rtol=1e-5, atol=1e-4)
        meta = ((rank << 2) | lane).int()
        got = blocked_rank_reduce(gd, meta, starts, 68, 4, True)
        assert torch.equal(got[:1000], rank_reduce(gd, lane, start, end, 68, True))
        torch.testing.assert_close(got, blocked_rank_reduce_plain(
            gd, meta, starts, 68, 4, True), rtol=1e-5, atol=1e-4)
        table = torch.randn(3001, 128, device=dev).to(dt)
        idx = torch.randint(0, 3001, (3000,), device=dev, dtype=torch.int32)
        assert torch.equal(row_take(table, idx), row_take_plain(table, idx))
        pmeta = (torch.arange(gd.shape[0], device=dev) % 128 // 3
                 | lane.long() << 16).int()
        for out_dt in (torch.float32, torch.bfloat16):
            torch.testing.assert_close(
                rank_partial(gd, pmeta, 68, 4, True, bo=16, out_dtype=out_dt),
                rank_partial_plain(gd, pmeta, 68, 4, True, out_dtype=out_dt),
                rtol=8e-3, atol=1e-4)
    # the edge-case streams of tools.rank_cases: reruns bit for bit, the
    # plain versions within tolerance, kernel 5 bit for bit against
    # rank_reduce on the rank-mode plans
    from hplflownet_tpu_torch.tools.rank_cases import (fused_cases,
                                                       partial_cases, to_torch)
    for case in fused_cases():
        for dt in (torch.float32, torch.bfloat16):
            a = to_torch(case, dt, dev)
            args = (a["g"], a["meta"], a["start_rows"], case.c, case.r,
                    case.with_weights)
            got = blocked_rank_reduce(*args)
            assert torch.equal(got, blocked_rank_reduce(*args)), case.name
            torch.testing.assert_close(got, blocked_rank_reduce_plain(*args),
                                       rtol=1e-5, atol=1e-4)
            if case.rank_mode:
                assert torch.equal(got[:case.t], rank_reduce(
                    a["g"], a.get("rid"), a["start"], a["end"], case.c,
                    case.with_weights)), case.name
    for case in partial_cases():
        for dt in (torch.float32, torch.bfloat16):
            a = to_torch(case, dt, dev)
            args = (a["g"], a["meta"], case.c, case.r, case.with_weights)
            got = rank_partial(*args, out_dtype=dt)
            assert torch.equal(got, rank_partial(*args, out_dtype=dt)), case.name
            torch.testing.assert_close(
                got, rank_partial_plain(*args, out_dtype=dt),
                rtol=1e-5 if dt == torch.float32 else 8e-3, atol=1e-4)
    # kernel 2's edge cases (kernel 5 bit for bit on the plans' streams) and
    # kernel 4's, both against their plain versions
    from hplflownet_tpu_torch.tools.rank_cases import reduce_cases
    from hplflownet_tpu_torch.tools.tap_cases import tap_cases
    for case in reduce_cases():
        for dt in (torch.float32, torch.bfloat16):
            a = to_torch(case, dt, dev)
            args = (a["g"], a.get("rid"), a["start"], a["end"], case.c,
                    case.with_weights)
            got = rank_reduce(*args)
            assert torch.equal(got, rank_reduce(*args)), case.name
            torch.testing.assert_close(got, rank_reduce_plain(*args),
                                       rtol=1e-5, atol=1e-4)
            if case.meta is not None:
                assert torch.equal(got, blocked_rank_reduce(
                    a["g"], a["meta"], a["start_rows"], case.c, case.r,
                    case.with_weights)[:case.start.shape[0]]), case.name
    for case in tap_cases():
        n = torch.from_numpy(case.nb).to(dev)
        for dt in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(case.tables).to(dev, dt)
            got = stencil_tap_tables_sum(t, case.c, n)
            assert torch.equal(got, stencil_tap_tables_sum(t, case.c, n))
            torch.testing.assert_close(
                got, stencil_tap_tables_sum_plain(t, case.c, n),
                rtol=1e-6, atol=1e-5)
