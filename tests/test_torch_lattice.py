"""The port's lattice pyramid against the JAX package's, table for table.

Every field of every ``ScalePair`` — integer tables, splat plans, overflow
counters, and the float barycentric weights and residuals — must equal JAX
``build_pyramid`` run under ``exact_mode()`` (window-free probes, like the
port), bit for bit.  Geometry is compared bit for bit too, on generic
points and on vertex-derived points that sit exactly on rounding ties.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.lattice import (LatticeSpec as JaxSpec, ScaleSpec as JaxScale,
                                    build_pyramid as jax_build_pyramid)
from hplflownet_tpu.lattice.geometry import PermutohedralGeometry
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu_torch.lattice import (LatticeSpec, ScaleSpec, build_pyramid,
                                          filter_size, neighborhood_offsets,
                                          tap_negation)
from hplflownet_tpu_torch.lattice.capacity import (measured_default_capacities,
                                                   synthetic_frustum_clouds)
from hplflownet_tpu_torch.lattice.geometry import elevate, simplex_from_elevated

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]


def _n64_pair():
    rng = np.random.RandomState(11)             # tests/test_e2e_parity.py:256
    pc1 = (rng.randn(64, 3) * 2.0).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(64, 3).astype(np.float32)
    return pc1, pc2


def _frustum_pair(n, seed):
    a, b = synthetic_frustum_clouds(1, n, seed=seed)
    return a[0], b[0]


def _assert_pyramids_equal(pc1, pc2, caps, adjoint_plans, valid=None,
                           bits=10):
    jspec = JaxSpec(d=3, scales=tuple(JaxScale(s, b, f, c, capacity=cap)
                                      for (s, b, f, c), cap in zip(SFM7, caps)),
                    coord_bits=bits)
    tspec = LatticeSpec(d=3, scales=tuple(ScaleSpec(s, b, f, c, capacity=cap)
                                          for (s, b, f, c), cap in zip(SFM7, caps)),
                        coord_bits=bits)
    v1 = v2 = None
    if valid is not None:
        v1, v2 = valid
    with exact_mode():
        want = jax.jit(lambda a, b, x, y: jax_build_pyramid(
            jspec, a, b, x, y, adjoint_plans=adjoint_plans))(
                jnp.asarray(pc1), jnp.asarray(pc2),
                None if v1 is None else jnp.asarray(v1),
                None if v2 is None else jnp.asarray(v2))
    got = build_pyramid(tspec, torch.from_numpy(pc1), torch.from_numpy(pc2),
                        None if v1 is None else torch.from_numpy(v1),
                        None if v2 is None else torch.from_numpy(v2),
                        adjoint_plans=adjoint_plans)
    assert len(got) == len(want) == 7
    for i, (w, g) in enumerate(zip(want, got)):
        assert g._fields == w._fields and len(g._fields) == 20
        for name in w._fields:
            wv, gv = getattr(w, name), getattr(g, name)
            pairs = (zip(wv._fields, wv, gv) if name.endswith("splat_plan")
                     else [(name, wv, gv)])
            for sub, a, b in pairs:
                a = np.asarray(a)
                b = b.numpy()
                assert a.shape == b.shape, (i, name, sub, a.shape, b.shape)
                assert a.dtype == b.dtype, (i, name, sub, a.dtype, b.dtype)
                np.testing.assert_array_equal(b, a, err_msg=f"scale {i} {name}.{sub}")
    return got


@pytest.mark.parametrize("adjoint_plans,bits", [(False, 10), (True, 10),
                                                (False, 15)])
def test_n64_pyramid_equals_jax(adjoint_plans, bits):
    """bits 15 packs each key into two int32 words (wide scenes)."""
    pc1, pc2 = _n64_pair()
    got = _assert_pyramids_equal(pc1, pc2, [320, 576, 448, 192, 128, 64, 64],
                                 adjoint_plans, bits=bits)
    # vertex counts grow from scale 3.0 to 2.0 (252 -> 521)
    assert [int(s.pc1_num_valid) for s in got][:2] == [252, 521]
    assert all(int(s.pc1_overflow) == 0 for s in got)


def test_n1024_frustum_pyramid_equals_jax():
    pc1, pc2 = _frustum_pair(1024, seed=3)     # 3887/7656/5592/2431/617/179/72
    got = _assert_pyramids_equal(pc1, pc2, [4096, 8192, 6144, 2560, 768, 256, 128],
                                 adjoint_plans=True)
    assert all(int(s.pc1_overflow) == 0 for s in got)


def test_capacity_overflow_drops_and_counts_the_same_vertices():
    pc1, pc2 = _frustum_pair(1024, seed=3)
    valid1 = np.ones(1024, bool)
    valid1[::7] = False                     # invalid points are inert
    got = _assert_pyramids_equal(pc1, pc2, [1024, 2048, 1024, 512, 256, 128, 64],
                                 adjoint_plans=False,
                                 valid=(valid1, np.ones(1024, bool)))
    assert sum(int(s.pc1_overflow) + int(s.pc2_overflow) for s in got) > 0


@pytest.mark.parametrize("scale", [3.0, 1.0, 0.0625])
def test_elevation_is_bit_exact(scale):
    rng = np.random.RandomState(5)
    pts = (rng.randn(20000, 3) * 8).astype(np.float32)
    geom = PermutohedralGeometry(3)
    want = np.asarray(geom.elevate(jnp.asarray(pts), scale))
    np.testing.assert_array_equal(elevate(torch.from_numpy(pts), scale).numpy(), want)


def test_simplex_rounding_ties_are_bit_exact():
    """Vertex-derived points (key * ratio) sit on rounding ties; generic
    points do not.  Keys, weights and residuals match JAX on both."""
    rng = np.random.RandomState(9)
    geom = PermutohedralGeometry(3)
    keys = rng.randint(-60, 60, (5000, 3)) * 4
    keys = np.concatenate([keys, -keys.sum(1, keepdims=True)], 1)
    ties = keys.astype(np.float32) * (np.float32(2.0) / np.float32(3.0))
    generic = np.asarray(geom.elevate(jnp.asarray(
        (rng.randn(5000, 3) * 6).astype(np.float32)), 1.0))
    for elev in (ties, generic):
        want = geom.simplex_from_elevated(jnp.asarray(elev))
        got = simplex_from_elevated(torch.from_numpy(np.array(elev)))
        for name in ("keys", "barycentric", "el_minus_gr"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))


def test_offsets_and_capacities_equal_the_jax_copies():
    from hplflownet_tpu.lattice import capacity as jax_capacity
    from hplflownet_tpu.lattice import offsets as jax_offsets
    for radius in (1, 2):
        assert filter_size(radius, 3) == jax_offsets.filter_size(radius, 3)
        np.testing.assert_array_equal(neighborhood_offsets(radius, 3),
                                      jax_offsets.neighborhood_offsets(radius, 3))
        assert tap_negation(radius, 3) == jax_offsets.tap_negation(radius, 3)
    for a, b in zip(synthetic_frustum_clouds(2, 300, seed=4),
                    jax_capacity.synthetic_frustum_clouds(2, 300, seed=4)):
        np.testing.assert_array_equal(a, b)
    assert (measured_default_capacities(256, SFM7, seeds=(0,))
            == jax_capacity.measured_default_capacities(256, SFM7, seeds=(0,)))
