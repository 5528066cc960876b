"""The port's ops against the JAX package's, on lattice tables.

splat, blur, slice, corr_self, corr_cross, apply_reduce_plan, gather_rows
and the BilateralConv / BilateralCorrelation modules get the same numpy
inputs and the same lattice tables (the port's pyramid, which equals JAX's
bit for bit — tests/test_torch_lattice.py) on both sides.  Tolerances: float32 results
differ only in summation order (rtol/atol 1e-5, 1e-4 through the wide
contractions); bf16 results may round one bf16 ulp apart (2^-8).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.lattice.offsets import tap_negation
from hplflownet_tpu.ops import bcl as jbcl
from hplflownet_tpu.ops import corr as jcorr
from hplflownet_tpu.ops import segment as jseg
from hplflownet_tpu_torch.lattice import LatticeSpec, ScaleSpec, build_pyramid
from hplflownet_tpu_torch.ops import bcl, corr, segment
from hplflownet_tpu_torch.params import params_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NEG15 = tap_negation(1, 3)
SFM3 = [[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1]]
DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


def _pyramid(caps=(448, 192, 128), seed=0):
    rng = np.random.RandomState(seed)
    pc1 = (rng.randn(96, 3) * 2.5).astype(np.float32)
    pc2 = pc1 + 0.1 * rng.randn(96, 3).astype(np.float32)
    spec = LatticeSpec(d=3, scales=tuple(
        ScaleSpec(s, b, f, c, capacity=cap) for (s, b, f, c), cap in zip(SFM3, caps)))
    return build_pyramid(spec, torch.from_numpy(pc1), torch.from_numpy(pc2)), rng


def _j(x):
    """A torch tensor (or a ReducePlan of them) as jax arrays."""
    if isinstance(x, segment.ReducePlan):
        return jseg.ReducePlan(*[jnp.asarray(t.numpy()) for t in x])
    return jnp.asarray(x.numpy())


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16):
    got = got.float().numpy()
    if bf16:
        np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("normalize", [True, False])
def test_splat_matches_jax(jdt, tdt, normalize):
    scales, rng = _pyramid()
    for i in (0, 2):                      # metric points, then vertex points
        sp = scales[i]
        n = sp.pc1_barycentric.shape[0]
        feats = rng.randn(n, 68).astype(np.float32)
        want = _np(jbcl.splat(jnp.asarray(feats, jdt), _j(sp.pc1_barycentric),
                              _j(sp.pc1_splat_plan), normalize=normalize))
        got = bcl.splat(torch.from_numpy(feats).to(tdt), sp.pc1_barycentric,
                        sp.pc1_splat_plan, normalize=normalize)
        assert got.dtype == torch.float32
        # same bf16 products on both sides; only the f32 sum order differs
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_weighted_reduce_with_a_generic_plan_matches_jax():
    rng = np.random.RandomState(3)
    ids = rng.randint(-1, 40, (300, 4)).astype(np.int32)
    rows = rng.randn(300, 9).astype(np.float32)
    w = rng.rand(300, 4).astype(np.float32)
    jplan = jseg.make_reduce_plan(jnp.asarray(ids), 40)
    tplan = segment.make_reduce_plan(torch.from_numpy(ids), 40)
    for name in jseg.ReducePlan._fields:
        np.testing.assert_array_equal(getattr(tplan, name).numpy(),
                                      np.asarray(getattr(jplan, name)))
    want = np.asarray(jseg.weighted_reduce(True, jplan, jnp.asarray(rows),
                                           jnp.asarray(w)))
    got = segment.weighted_reduce(True, tplan, torch.from_numpy(rows),
                                  torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("slope", [None, 0.0, 0.1])
def test_blur_matches_jax(jdt, tdt, slope):
    scales, rng = _pyramid()
    sp = scales[0]
    h = sp.pc1_blur_neighbors.shape[1]
    table = rng.randn(h + 1, 20).astype(np.float32)
    table[0] = 0.0
    kern = (rng.randn(15, 20, 24) * 0.2).astype(np.float32)
    bias = rng.randn(24).astype(np.float32)
    want = _np(jbcl.blur_matmul(NEG15, slope, jnp.dtype(jdt).name,
                                jnp.asarray(table, jdt), _j(sp.pc1_blur_neighbors),
                                jnp.asarray(kern, jdt), jnp.asarray(bias)))
    got = bcl.blur(torch.from_numpy(table).to(tdt), sp.pc1_blur_neighbors,
                   torch.from_numpy(kern).to(tdt), torch.from_numpy(bias),
                   slope, tdt)
    assert got.dtype == tdt
    _close(got, want, tdt == torch.bfloat16)


@pytest.mark.parametrize("caps", [(448, 192, 128), (160, 64, 32)])
def test_slice_matches_jax_and_zeroes_absent_vertices(caps):
    scales, rng = _pyramid(caps=caps)
    for sp in scales:
        h = sp.pc1_blur_neighbors.shape[1]
        blurred = rng.randn(h, 16).astype(np.float32)
        want = np.asarray(jbcl.slice_to_points(
            jnp.asarray(blurred), _j(sp.pc1_barycentric),
            _j(sp.pc1_lattice_offset), _j(sp.pc1_splat_plan)))
        got = bcl.slice_to_points(torch.from_numpy(blurred), sp.pc1_barycentric,
                                  sp.pc1_lattice_offset)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the small capacities overflow: a valid point whose vertex was dropped
    # must not read row 0
    if caps[0] == 160:
        assert any(int(s.pc1_overflow) > 0 for s in scales)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_corr_self_and_corr_cross_match_jax(jdt, tdt):
    scales, rng = _pyramid()
    sp = scales[1]
    h1 = sp.pc1_blur_neighbors.shape[1]
    h2 = sp.pc2_blur_neighbors.shape[1]
    c, w, nf = 12, 8, 15
    pad1 = rng.randn(h1 + 1, 2 * c).astype(np.float32)
    pad2 = rng.randn(h2 + 1, c).astype(np.float32)
    pad1[0] = pad2[0] = 0.0
    k_self = (rng.randn(15, 2 * c, w) * 0.2).astype(np.float32)
    bias = rng.randn(w).astype(np.float32)
    want = _np(jcorr.corr_self(NEG15, jnp.asarray(pad1, jdt), _j(sp.pc1_corr_indices),
                               jnp.asarray(k_self, jdt), jnp.asarray(bias)))
    got = corr.corr_self(torch.from_numpy(pad1).to(tdt), sp.pc1_corr_indices,
                         torch.from_numpy(k_self).to(tdt), torch.from_numpy(bias))
    assert got.dtype == torch.float32
    _close(got, want, False)

    u = sp.pc2_corr_uniq.shape[0]
    assert u == 65
    k_cross = (rng.randn(15, c, w) * 0.2).astype(np.float32)
    onehot = jax.nn.one_hot(_j(sp.pc2_corr_inverse), u, dtype=jdt)
    k2_j = jnp.einsum("fku,kcw->ucfw", onehot, jnp.asarray(k_cross, jdt),
                      preferred_element_type=jnp.float32).astype(jdt)
    k2_t = corr.fold_cross_kernel(torch.from_numpy(k_cross), sp.pc2_corr_inverse,
                                  u, tdt)
    np.testing.assert_array_equal(k2_t.float().numpy(), _np(k2_j))
    want = _np(jcorr.corr_cross(jnp.asarray(pad2, jdt), _j(sp.pc2_corr_uniq),
                                k2_j, _j(sp.pc2_corr_uniq_inv)))
    got = corr.corr_cross(torch.from_numpy(pad2).to(tdt), sp.pc2_corr_uniq, k2_t)
    assert got.shape == (h1, nf, w)
    _close(got, want, False)
    np.testing.assert_array_equal(
        corr.gather_rows(torch.from_numpy(pad2), sp.pc2_corr_uniq).numpy(),
        np.asarray(jcorr.gather_rows(jnp.asarray(pad2), _j(sp.pc2_corr_uniq),
                                     _j(sp.pc1_splat_plan))))


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("encoder", [True, False])
def test_bilateral_conv_module_matches_flax(dt, encoder):
    scales, rng = _pyramid()
    sp = scales[0]
    n = sp.pc1_barycentric.shape[0]
    h = sp.pc1_blur_neighbors.shape[1]
    feats = rng.randn(n if encoder else h, 10).astype(np.float32)
    jmod = jbcl.BilateralConv(widths=(12, 9), filter_size=15, do_splat=encoder,
                              do_slice=not encoder, tap_negation=NEG15,
                              compute_dtype=dt)
    kw = dict(in_barycentric=_j(sp.pc1_barycentric),
              splat_plan=_j(sp.pc1_splat_plan),
              blur_neighbors=_j(sp.pc1_blur_neighbors),
              out_barycentric=_j(sp.pc1_barycentric),
              out_lattice_offset=_j(sp.pc1_lattice_offset),
              out_splat_plan=_j(sp.pc1_splat_plan))
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(feats), **kw)
    params = jax.tree_util.tree_map(
        lambda a: a + 0.05 * jnp.ones_like(a), params)     # nonzero biases
    want = _np(jmod.apply(params, jnp.asarray(feats), **kw))
    tdt = getattr(torch, dt)
    tmod = bcl.BilateralConv((12, 9), 15, 10, do_splat=encoder,
                             do_slice=not encoder, compute_dtype=tdt,
                             device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), tmod)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(feats), sp.pc1_barycentric, sp.pc1_splat_plan,
                   sp.pc1_blur_neighbors, sp.pc1_barycentric, sp.pc1_lattice_offset)
    assert got.dtype == tdt
    _close(got, want, dt == "bfloat16")


def test_bilateral_correlation_module_matches_flax():
    scales, rng = _pyramid()
    sp = scales[1]
    h1 = sp.pc1_blur_neighbors.shape[1]
    h2 = sp.pc2_blur_neighbors.shape[1]
    n_in = sp.pc1_barycentric.shape[0]
    feat1 = rng.randn(h1, 6).astype(np.float32)
    feat2 = rng.randn(h2, 6).astype(np.float32)
    prev = rng.randn(n_in, 3).astype(np.float32)
    jmod = jcorr.BilateralCorrelation(corr_widths=(5, 4), widths=(7, 6),
                                      corr_size=15, filter_size=15,
                                      corr_tap_negation=NEG15, prev_corr_dim=3)
    args = dict(prev_corr_feat=jnp.asarray(prev),
                barycentric1=_j(sp.pc1_barycentric),
                splat_plan1=_j(sp.pc1_splat_plan),
                pc1_corr_indices=_j(sp.pc1_corr_indices),
                pc2_corr_uniq=_j(sp.pc2_corr_uniq),
                pc2_corr_inverse=_j(sp.pc2_corr_inverse),
                pc2_corr_uniq_inv=_j(sp.pc2_corr_uniq_inv))
    params = jmod.init(jax.random.PRNGKey(1), jnp.asarray(feat1),
                       jnp.asarray(feat2), **args)
    want = np.asarray(jmod.apply(params, jnp.asarray(feat1), jnp.asarray(feat2),
                                 **args))
    tmod = corr.BilateralCorrelation((5, 4), (7, 6), 15, 15, 6, prev_corr_dim=3,
                                     device="cpu")
    params_from_jax(jax.tree_util.tree_map(np.asarray, params), tmod)
    with torch.inference_mode():
        got = tmod(torch.from_numpy(feat1), torch.from_numpy(feat2),
                   torch.from_numpy(prev), sp.pc1_barycentric, sp.pc1_splat_plan,
                   sp.pc1_corr_indices, sp.pc2_corr_uniq, sp.pc2_corr_inverse)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# backward: each autograd Function against jax.vjp of the JAX function
# ---------------------------------------------------------------------------

def _grads_close(got, want, bf16):
    """float32: sums in another order (atol 1e-5 of the largest value);
    bf16: cotangents and products round to bf16 at the same places, a sum
    may land one bf16 ulp (2^-8) apart and carry (atol 1e-2 of the largest)."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=(1e-2 if bf16 else 1e-5) * scale)


def _leaf(a, dt):
    return torch.from_numpy(np.asarray(a)).to(dt).requires_grad_(True)


def test_relu_and_leaky_gradients_at_zero_match_jax():
    x = np.asarray([0.0, -1.0, 1.0], np.float32)
    for use_leaky, jfn, at_zero in (
            (False, jax.nn.relu, 0.0),
            (True, lambda v: jax.nn.leaky_relu(v, 0.1), 1.0)):
        want = np.asarray(jax.grad(lambda v: jnp.sum(jfn(v)))(jnp.asarray(x)))
        assert want[0] == at_zero
        t = torch.from_numpy(x).requires_grad_(True)
        bcl.activation(t, use_leaky).sum().backward()
        np.testing.assert_array_equal(t.grad.numpy(), want)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("with_w", [False, True])
def test_weighted_reduce_vjp_matches_jax(jdt, tdt, with_w):
    scales, rng = _pyramid()
    sp = scales[1]                       # vertex points, some invalid
    n = sp.pc1_barycentric.shape[0]
    rows = rng.randn(n, 12).astype(np.float32)
    w = sp.pc1_barycentric.numpy()
    plan = sp.pc1_splat_plan
    ct = rng.randn(plan.start.shape[0], 12 + int(with_w)).astype(np.float32)
    _, vjp = jax.vjp(lambda r, ww: jseg.weighted_reduce(with_w, _j(plan), r, ww),
                     jnp.asarray(rows, jdt), jnp.asarray(w))
    want_rows, want_w = vjp(jnp.asarray(ct))
    tr, tw = _leaf(rows, tdt), _leaf(w, torch.float32)
    out = segment.weighted_reduce(with_w, plan, tr, tw)
    got_rows, got_w = torch.autograd.grad(out, (tr, tw), torch.from_numpy(ct))
    assert got_rows.dtype == tdt
    _grads_close(got_rows, want_rows, tdt == torch.bfloat16)
    _grads_close(got_w, want_w, False)   # float32 either way, as in JAX


@pytest.mark.parametrize("jdt,tdt", DTYPES)
@pytest.mark.parametrize("slope", [None, 0.0, 0.1])
def test_blur_vjp_matches_jax(jdt, tdt, slope):
    scales, rng = _pyramid()
    sp = scales[0]
    nb = sp.pc1_blur_neighbors
    h = nb.shape[1]
    table = rng.randn(h + 1, 20).astype(np.float32)
    table[0] = 0.0
    kern = (rng.randn(15, 20, 24) * 0.2).astype(np.float32)
    # biases that put exact zeros before the activation where the stencil
    # is empty (padding rows), the case whose gradient rule differs
    bias = np.where(rng.rand(24) < 0.3, 0.0, rng.randn(24)).astype(np.float32)
    out_dt = jnp.dtype(jdt).name
    y, vjp = jax.vjp(lambda t, k, b: jbcl.blur_matmul(
        NEG15, slope, out_dt, t, _j(nb), k, b),
        jnp.asarray(table, jdt), jnp.asarray(kern, jdt), jnp.asarray(bias))
    ct = jnp.asarray(rng.randn(*y.shape).astype(np.float32), jdt)
    want = vjp(ct)
    leaves = (_leaf(table, tdt), _leaf(kern, tdt), _leaf(bias, torch.float32))
    out = bcl.blur(leaves[0], nb, leaves[1], leaves[2], slope, tdt, NEG15)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(_np(ct).copy()).to(tdt))
    assert [g.dtype for g in got] == [tdt, tdt, torch.float32]
    for g, w in zip(got, want):
        _grads_close(g, w, tdt == torch.bfloat16)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_slice_vjp_matches_jax(jdt, tdt):
    scales, rng = _pyramid(caps=(160, 64, 32))     # overflowing vertices too
    for sp in scales:
        h = sp.pc1_blur_neighbors.shape[1]
        blurred = rng.randn(h, 16).astype(np.float32)
        bary = sp.pc1_barycentric.numpy()
        y, vjp = jax.vjp(lambda b, w: jbcl.slice_to_points(
            b, w, _j(sp.pc1_lattice_offset), _j(sp.pc1_splat_plan)),
            jnp.asarray(blurred, jdt), jnp.asarray(bary))
        ct = rng.randn(*y.shape).astype(np.float32)
        want_b, want_w = vjp(jnp.asarray(ct))
        tb, tw = _leaf(blurred, tdt), _leaf(bary, torch.float32)
        out = bcl.slice_to_points(tb, tw, sp.pc1_lattice_offset,
                                  sp.pc1_splat_plan)
        got_b, got_w = torch.autograd.grad(out, (tb, tw), torch.from_numpy(ct))
        assert got_b.dtype == tdt
        _grads_close(got_b, want_b, tdt == torch.bfloat16)
        _grads_close(got_w, want_w, False)


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_corr_self_and_corr_cross_vjps_match_jax(jdt, tdt):
    """corr_cross: the port's tap-tables adjoint (z = g @ k2^T, then the
    gather-sum through uniq_inv) equals the JAX CPU path's plain stencil
    over the cotangent."""
    scales, rng = _pyramid()
    sp = scales[1]
    h1 = sp.pc1_blur_neighbors.shape[1]
    h2 = sp.pc2_blur_neighbors.shape[1]
    c, w = 12, 8
    bf16 = tdt == torch.bfloat16
    pad1 = rng.randn(h1 + 1, 2 * c).astype(np.float32)
    pad2 = rng.randn(h2 + 1, c).astype(np.float32)
    pad1[0] = pad2[0] = 0.0
    k_self = (rng.randn(15, 2 * c, w) * 0.2).astype(np.float32)
    bias = rng.randn(w).astype(np.float32)
    y, vjp = jax.vjp(lambda t, k, b: jcorr.corr_self(
        NEG15, t, _j(sp.pc1_corr_indices), k, b),
        jnp.asarray(pad1, jdt), jnp.asarray(k_self, jdt), jnp.asarray(bias))
    ct = rng.randn(*y.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    leaves = (_leaf(pad1, tdt), _leaf(k_self, tdt), _leaf(bias, torch.float32))
    out = corr.corr_self(leaves[0], sp.pc1_corr_indices, leaves[1], leaves[2],
                         NEG15)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    for g, wnt in zip(got, want):
        _grads_close(g, wnt, bf16)

    u = sp.pc2_corr_uniq.shape[0]
    k2 = (rng.randn(u, c, 15, w) * 0.2).astype(np.float32)
    y, vjp = jax.vjp(lambda p, k: jcorr.corr_cross(
        p, _j(sp.pc2_corr_uniq), k, _j(sp.pc2_corr_uniq_inv)),
        jnp.asarray(pad2, jdt), jnp.asarray(k2, jdt))
    ct = rng.randn(*y.shape).astype(np.float32)
    want = vjp(jnp.asarray(ct))
    leaves = (_leaf(pad2, tdt), _leaf(k2, tdt))
    out = corr.corr_cross(leaves[0], sp.pc2_corr_uniq, leaves[1],
                          sp.pc2_corr_uniq_inv)
    got = torch.autograd.grad(out, leaves, torch.from_numpy(ct))
    assert [g.dtype for g in got] == [tdt, tdt]
    for g, wnt in zip(got, want):
        _grads_close(g, wnt, bf16)


# ---------------------------------------------------------------------------
# plain-row reductions (apply_reduce_plan, gather_rows) and the fused route
# ---------------------------------------------------------------------------

def _long_runs_case():
    """tests/test_ops.py:442's ids: runs of 0 to 1200 entries (several span
    3-9 blocks of 128), many empty targets, ~5% sentinels."""
    rng = np.random.RandomState(11)
    t = 37
    lens = rng.choice([0, 0, 1, 2, 7, 130, 400, 1200], size=t,
                      p=[.25, .15, .2, .15, .1, .06, .05, .04])
    ids = np.repeat(np.arange(t, dtype=np.int32), lens)
    rng.shuffle(ids)
    ids[rng.rand(ids.shape[0]) < 0.05] = -1
    vals = rng.randn(ids.shape[0], 5).astype(np.float32)
    return ids, vals, t, rng


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_apply_reduce_plan_and_its_vjp_match_jax(jdt, tdt):
    ids, vals, t, rng = _long_runs_case()
    jplan = jseg.make_reduce_plan(jnp.asarray(ids), t)
    tplan = segment.make_reduce_plan(torch.from_numpy(ids), t)
    y, vjp = jax.vjp(lambda v: jseg.apply_reduce_plan(jplan, v),
                     jnp.asarray(vals, jdt))
    ct = rng.randn(*y.shape).astype(np.float32)
    (want_d,) = vjp(jnp.asarray(ct, jdt))
    leaf = _leaf(vals, tdt)
    out = segment.apply_reduce_plan(tplan, leaf)
    assert out.dtype == tdt
    bf16 = tdt == torch.bfloat16
    # float32: JAX takes a run's share past its first block as a prefix
    # difference; bf16: the float32 sums round to bf16 on both sides
    scale = float(np.abs(vals).sum(0).max()) + 1.0
    np.testing.assert_allclose(out.detach().float().numpy(), _np(y),
                               rtol=8e-3 if bf16 else 0,
                               atol=(1e-2 if bf16 else 1e-5) * scale)
    want0 = np.zeros((t, 5))
    np.add.at(want0, ids[ids >= 0], vals[ids >= 0].astype(np.float64))
    np.testing.assert_allclose(out.detach().float().numpy(), want0,
                               rtol=8e-3 if bf16 else 1e-6,
                               atol=(1e-2 if bf16 else 1e-5) * scale)
    (got_d,) = torch.autograd.grad(out, leaf, torch.from_numpy(ct).to(tdt))
    assert got_d.dtype == tdt
    # the adjoint is a row gather: exact
    np.testing.assert_array_equal(got_d.float().numpy(), _np(want_d))


@pytest.mark.parametrize("jdt,tdt", DTYPES)
def test_gather_rows_and_its_plan_adjoint_match_jax(jdt, tdt):
    """tests/test_ops.py:193's gather_rows case on the port's tables."""
    scales, rng = _pyramid()
    sp = scales[1]
    idx = sp.pc1_corr_indices
    cap = sp.pc1_blur_neighbors.shape[1]
    c = 6
    tbl = rng.randn(cap + 1, c).astype(np.float32)
    tbl[0] = 0.0
    jplan = jseg.make_reduce_plan(_j(idx), cap)
    tplan = segment.make_reduce_plan(idx, cap)
    y, vjp = jax.vjp(lambda tb: jcorr.gather_rows(tb, _j(idx), jplan),
                     jnp.asarray(tbl, jdt))
    ct = rng.randn(*y.shape).astype(np.float32)
    (want_d,) = vjp(jnp.asarray(ct, jdt))
    leaf = _leaf(tbl, tdt)
    out = corr.gather_rows(leaf, idx, tplan)
    np.testing.assert_array_equal(out.detach().float().numpy(), _np(y))
    (got_d,) = torch.autograd.grad(out, leaf, torch.from_numpy(ct).to(tdt))
    assert got_d.dtype == tdt
    _grads_close(got_d[1:], np.asarray(want_d)[1:], tdt == torch.bfloat16)
    with pytest.raises(ValueError, match="plan"):
        torch.autograd.grad(corr.gather_rows(leaf, idx).sum(), leaf)


def test_exact_mode_turns_the_fused_route_off(monkeypatch):
    from hplflownet_tpu_torch.ops.dispatch import (exact_mode, exact_mode_active,
                                                   rank_fused_enabled)
    monkeypatch.delenv("HPL_RANK_FUSED", raising=False)
    assert not rank_fused_enabled()
    monkeypatch.setenv("HPL_RANK_FUSED", "1")
    assert rank_fused_enabled()
    with exact_mode():
        assert exact_mode_active() and not rank_fused_enabled()
        with exact_mode(False):
            assert rank_fused_enabled()
    assert not exact_mode_active() and rank_fused_enabled()
    # and the splat under exact_mode() does not reach the fused kernel
    from hplflownet_tpu_torch.kernels import rank_fused
    scales, rng = _pyramid()
    sp = scales[0]
    calls = []
    real = rank_fused.blocked_rank_reduce
    monkeypatch.setattr(segment, "blocked_rank_reduce",
                        lambda *a: calls.append(1) or real(*a))
    feats = torch.from_numpy(rng.randn(sp.pc1_barycentric.shape[0], 4)
                             .astype(np.float32))
    with exact_mode():
        bcl.splat(feats, sp.pc1_barycentric, sp.pc1_splat_plan)
    assert not calls


@pytest.mark.parametrize("caps", [(448, 192, 128), (160, 64, 32)])
def test_fused_route_equals_the_default_route(caps, monkeypatch):
    """With invalid points and (at the small capacities) vertices dropped
    past capacity, whose points keep their weights: the fused route's
    ranks skip them as the default route's runs do.  Both plain versions
    sum in float64, so they agree to float32 rounding."""
    from hplflownet_tpu_torch.kernels import rank_fused
    rng = np.random.RandomState(4)
    pc1 = (rng.randn(96, 3) * 2.5).astype(np.float32)
    pc2 = pc1 + 0.1 * rng.randn(96, 3).astype(np.float32)
    valid = rng.rand(96) > 0.2
    spec = LatticeSpec(d=3, scales=tuple(
        ScaleSpec(s, b, f, c, capacity=cap) for (s, b, f, c), cap in zip(SFM3, caps)))
    scales = build_pyramid(spec, torch.from_numpy(pc1), torch.from_numpy(pc2),
                           torch.from_numpy(valid), torch.from_numpy(valid))
    if caps[0] == 160:
        assert any(int(s.pc1_overflow) > 0 for s in scales)
    calls = []
    real = rank_fused.blocked_rank_reduce
    monkeypatch.setattr(segment, "blocked_rank_reduce",
                        lambda *a: calls.append(1) or real(*a))
    for sp in scales:
        for plan, bary in ((sp.pc1_splat_plan, sp.pc1_barycentric),
                           (sp.pc2_splat_plan, sp.pc2_barycentric)):
            rows = torch.from_numpy(rng.randn(bary.shape[0], 7).astype(np.float32))
            for with_w in (False, True):
                monkeypatch.delenv("HPL_RANK_FUSED", raising=False)
                want = segment.weighted_reduce(with_w, plan, rows, bary)
                monkeypatch.setenv("HPL_RANK_FUSED", "1")
                got = segment.weighted_reduce(with_w, plan, rows, bary)
                torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert len(calls) == 4 * len(scales)


def test_flagship_forward_and_gradients_on_the_fused_route(monkeypatch):
    """Under HPL_RANK_FUSED=1 the 7-scale forward and train step still
    match the frozen JAX references, at their tests' tolerances, and every
    splat and slice adjoint went through the fused kernel."""
    import chip_smoke
    from hplflownet_tpu_torch.kernels import rank_fused
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    from hplflownet_tpu_torch.train.step import loss_and_grad
    try:
        from test_torch_model import ATOL, MAX_REL, REF_NPZ, SFM7
    except ImportError:
        from tests.test_torch_model import ATOL, MAX_REL, REF_NPZ, SFM7
    calls = []
    real = rank_fused.blocked_rank_reduce
    monkeypatch.setattr(segment, "blocked_rank_reduce",
                        lambda *a: calls.append(1) or real(*a))
    monkeypatch.setenv("HPL_RANK_FUSED", "1")
    ref = np.load(REF_NPZ)
    model = HPLFlowNet(SFM7, device="cpu")
    params_from_jax(seeded_jax_params(model, int(ref["seed"])), model)
    spec = make_lattice_spec(SFM7, [int(c) for c in ref["capacities"]])
    flow = flow_forward(model, spec, ref["pc1"], ref["pc2"],
                        adjoint_plans=False).numpy()
    err = np.abs(flow - ref["flow"]).max()
    assert err <= ATOL and err / np.abs(ref["flow"]).max() <= MAX_REL, err
    assert len(calls) == 18

    tref = np.load(os.path.join(ROOT, chip_smoke.TRAIN_REF_NPZ))
    params_from_jax(seeded_jax_params(model, int(tref["seed"])), model)
    n = tref["pc1"].shape[1]
    batch = dict(pc1=tref["pc1"], pc2=tref["pc2"], sf=tref["sf"],
                 valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))
    loss, _, grads = loss_and_grad(
        model, make_lattice_spec(SFM7, [int(c) for c in tref["capacities"]]),
        dict(model.named_parameters()), batch)
    chip_smoke.check_train_reference(tref, float(loss), grads)
    assert len(calls) == 18 + 25
