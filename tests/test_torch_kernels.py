"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those are held
against the Pallas kernels run in interpret mode, on the inputs of the
JAX suite's own cases (tests/test_pallas_stencil.py), in float32: the
forward stencil, the splat reduction, the stencil's weight gradient
(``stencil_dkernel``) and the per-tap-table gather-sum.  A
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
from hplflownet_tpu.ops.segment import ReducePlan, _combine, local_ranks
from hplflownet_tpu_torch.kernels import (dkernel, plain_kernels, splat, stencil,
                                          tap_tables)
from hplflownet_tpu_torch.kernels.dkernel import (stencil_dkernel,
                                                  stencil_dkernel_plain,
                                                  vertex_splits)
from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
from hplflownet_tpu_torch.kernels.stencil import (stencil_gather_matmul,
                                                  stencil_gather_matmul_plain)
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
    # the flagship's three weight-gradient shapes and a tiny one
    for f, c_in, c_out, h in ((15, 580, 1024, 25600), (15, 128, 32, 12928),
                              (65, 64, 480, 12928), (15, 20, 8, 100)):
        splits, chunk = vertex_splits(f, c_in, c_out, h)
        assert chunk % 32 == 0 and splits * chunk >= h > (splits - 1) * chunk
        assert vertex_splits(f, c_in, c_out, h) == (splits, chunk)
    assert vertex_splits(15, 580, 1024, 25600)[0] == 1    # 2400 tiles: enough
    assert vertex_splits(15, 128, 32, 12928)[0] > 1       # 30 tiles: split


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
                stencil_tap_tables_sum)
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
    tabs = torch.zeros(10, 3 * 4)
    tap_tables._check_args(tabs, 4, nb)
    with pytest.raises(ValueError):
        tap_tables._check_args(tabs, 3, nb)
    with pytest.raises(TypeError):
        tap_tables._check_args(tabs.double(), 4, nb)
    with pytest.raises(TypeError):
        tap_tables._check_args(tabs, 4, nb.long())


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    rng = np.random.RandomState(0)
    table, nb, kern = _mk(rng, 3000, 15, 68, 64, 40)
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        t = torch.from_numpy(table).to(dev, dt)
        k = torch.from_numpy(kern).to(dev, dt)
        n = torch.from_numpy(nb).to(dev)
        bias = torch.linspace(-1, 1, 64, device=dev)
        got = stencil_gather_matmul(t, n, k, bias=bias, act_slope=0.1)
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
        for dt in (torch.float32, torch.bfloat16):
            t = torch.from_numpy(table).to(dev, dt)
            n = torch.from_numpy(nb).to(dev)
            got = stencil_dkernel(t, n, cot.to(dt))
            assert torch.equal(got, stencil_dkernel(t, n, cot.to(dt)))
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
