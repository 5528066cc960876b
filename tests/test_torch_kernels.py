"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU each wrapper runs its plain PyTorch version; here those are held
against the Pallas kernels run in interpret mode, on the inputs of the
JAX suite's own cases (tests/test_pallas_stencil.py), in float32.  A
``cuda``-marked test holds the CUDA kernels against the plain versions on a
card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.ops.pallas_stencil import (blocked_rank_partial,
                                               stencil_gather_matmul as pallas_stencil)
from hplflownet_tpu.ops.segment import ReducePlan, _combine, local_ranks
from hplflownet_tpu_torch.kernels import plain_kernels, stencil, splat
from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
from hplflownet_tpu_torch.kernels.stencil import (stencil_gather_matmul,
                                                  stencil_gather_matmul_plain)


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
    before = (stencil_gather_matmul.launches, rank_reduce.launches)
    out = stencil_gather_matmul(table, nb, kern)
    torch.testing.assert_close(out, stencil_gather_matmul_plain(table, nb, kern))
    g = torch.randn(20, 6)
    rid = torch.zeros(20, dtype=torch.int32)
    bounds = torch.tensor([0, 20], dtype=torch.int32)
    rank_reduce(g, rid, bounds[:1], bounds[1:], 5)
    with plain_kernels():
        stencil_gather_matmul(table, nb, kern)
    assert (stencil_gather_matmul.launches, rank_reduce.launches) == before


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
