"""The port's fused two-cloud lattice build (``HPL_FUSED_BUILD``) and
``pipeline.batched_flow_forward``, on the CPU.

* ``_build_two_from_elevated`` equals two ``_build_from_elevated`` calls on
  every ``CloudLattice`` field, splat plan included, bit for bit (random
  validity masks; one and two key words; capacity overflow): the JAX
  package's tests/test_lattice_build.py:338-418 against the port's own
  unfused path.
* ``build_pyramid`` under ``HPL_FUSED_BUILD`` "1" (every scale fused) and
  "512" (a threshold: scales 0 and 2 fused, 1 not) equals "0" on every
  field, adjoint plans on (test_lattice_build.py:421-470); with "1" it
  equals JAX's ``build_pyramid`` under ``exact_mode()`` with the same
  setting (SFM7, the 64-point pair of tests/test_torch_lattice.py, bits 10
  and 15), bit for bit; under ``probe_sharding`` (one rank, and the
  per-cloud fallback of a split probe) the tables are the unsharded ones.
* ``batched_flow_forward`` (the shallow model, B = 2, n = 64, float32, some
  points invalid, JAX's seeded weights) equals the port's per-sample
  ``flow_forward`` bit for bit and JAX's ``batched_flow_forward`` within
  atol 1e-3 and max-rel 5e-3, the bounds of the model tests.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.lattice import (LatticeSpec as JaxSpec, ScaleSpec as JaxScale,
                                    build_pyramid as jax_build_pyramid)
from hplflownet_tpu.models import HPLFlowNetShallow as JaxShallow
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu.pipeline import batched_flow_forward as jax_batched_flow_forward
from hplflownet_tpu_torch.lattice import LatticeSpec, ScaleSpec, build_pyramid
from hplflownet_tpu_torch.lattice import build as tbuild
from hplflownet_tpu_torch.lattice.geometry import elevate
from hplflownet_tpu_torch.models import HPLFlowNetShallow
from hplflownet_tpu_torch.ops.shard import AxisShard
from hplflownet_tpu_torch.parallel import make_mesh
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import (batched_flow_forward, flow_forward,
                                           make_lattice_spec)

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
SFM5 = SFM7[2:]
ATOL, MAX_REL = 1e-3, 5e-3


def _assert_same(got, want, what):
    """Every tensor of two (nested) named tuples equal, dtype and bits."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want), what
        names = getattr(want, "_fields", range(len(want)))
        for name, g, w in zip(names, got, want):
            _assert_same(g, w, f"{what}.{name}")
        return
    if not isinstance(want, torch.Tensor):
        want = torch.from_numpy(np.array(want))
    assert got.dtype == want.dtype and got.shape == want.shape, what
    assert torch.equal(got, want), what


def _elevated_pair(rng, n, scale, noise=0.2):
    pc1 = rng.randn(n, 3).astype(np.float32) * 3.0
    pc2 = pc1 + noise * rng.randn(n, 3).astype(np.float32)
    return (elevate(torch.from_numpy(pc1), scale),
            elevate(torch.from_numpy(pc2), scale))


@pytest.mark.parametrize("bits", [10, 15])
@pytest.mark.parametrize("n,cap,scale", [(96, 512, 1.0), (160, 256, 0.5),
                                         (64, 96, 2.0)])
def test_fused_build_equals_two_builds(n, cap, scale, bits):
    rng = np.random.RandomState(5 + n)
    e1, e2 = _elevated_pair(rng, n, scale)
    v1 = torch.from_numpy(rng.rand(n) > 0.1)
    v2 = torch.from_numpy(rng.rand(n) > 0.1)
    fused = tbuild._build_two_from_elevated(e1, v1, e2, v2, cap, bits)
    for c, (e, v) in enumerate(((e1, v1), (e2, v2))):
        _assert_same(fused[c], tbuild._build_from_elevated(e, v, cap, bits),
                     f"pc{c + 1}")


def test_fused_build_capacity_overflow():
    rng = np.random.RandomState(9)
    n, cap = 128, 64      # far under the ~500 occupied vertices
    pc1 = rng.randn(n, 3).astype(np.float32) * 3.0
    pc2 = rng.randn(n, 3).astype(np.float32) * 3.0
    e1, e2 = (elevate(torch.from_numpy(p), 1.0) for p in (pc1, pc2))
    ones = torch.ones(n, dtype=torch.bool)
    fused = tbuild._build_two_from_elevated(e1, ones, e2, ones, cap)
    for c, e in enumerate((e1, e2)):
        want = tbuild._build_from_elevated(e, ones, cap)
        assert int(want.overflow) > 0 and int(want.num_valid) == cap
        _assert_same(fused[c], want, f"pc{c + 1}")


def _threshold_case():
    rng = np.random.RandomState(11)
    n = 96
    pc1 = rng.randn(n, 3).astype(np.float32) * 3.0
    pc2 = pc1 + 0.2 * rng.randn(n, 3).astype(np.float32)
    valid = [torch.from_numpy(rng.rand(n) > 0.08) for _ in range(2)]
    spec = make_lattice_spec([[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1]],
                             capacities=[512, 640, 384])
    return spec, torch.from_numpy(pc1), torch.from_numpy(pc2), valid


@pytest.mark.parametrize("mode", ["1", "512"])
def test_fused_pyramid_equals_unfused(mode, monkeypatch):
    spec, pc1, pc2, (v1, v2) = _threshold_case()
    monkeypatch.setenv("HPL_FUSED_BUILD", "0")
    want = build_pyramid(spec, pc1, pc2, v1, v2, adjoint_plans=True)
    monkeypatch.setenv("HPL_FUSED_BUILD", mode)
    calls = []
    real = tbuild._build_two_from_elevated
    monkeypatch.setattr(tbuild, "_build_two_from_elevated",
                        lambda *a: calls.append(a[4]) or real(*a))
    got = build_pyramid(spec, pc1, pc2, v1, v2, adjoint_plans=True)
    assert calls == ([512, 640, 384] if mode == "1" else [512, 384])
    _assert_same(got, want, f"HPL_FUSED_BUILD={mode}")


def test_fused_build_threshold_reads_the_variable(monkeypatch):
    for value, want in (("", -1), ("0", -1), (" 1 ", 1 << 30), ("3584", 3584)):
        monkeypatch.setenv("HPL_FUSED_BUILD", value)
        assert tbuild._fused_build_threshold() == want
    monkeypatch.delenv("HPL_FUSED_BUILD")
    assert tbuild._fused_build_threshold() == -1


def _n64_pair():
    rng = np.random.RandomState(11)             # tests/test_torch_lattice.py
    pc1 = (rng.randn(64, 3) * 2.0).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(64, 3).astype(np.float32)
    return pc1, pc2


N64_CAPS = [320, 576, 448, 192, 128, 64, 64]


def _n64_specs(bits):
    rows = list(zip(SFM7, N64_CAPS))
    return (LatticeSpec(d=3, scales=tuple(ScaleSpec(*r, capacity=c) for r, c in rows),
                        coord_bits=bits),
            JaxSpec(d=3, scales=tuple(JaxScale(*r, capacity=c) for r, c in rows),
                    coord_bits=bits))


@pytest.mark.parametrize("bits", [10, 15])
def test_fused_pyramid_equals_jax(bits, monkeypatch):
    """bits 15: two key words, so the tag sits above both in the sort key."""
    monkeypatch.setenv("HPL_FUSED_BUILD", "1")
    pc1, pc2 = _n64_pair()
    tspec, jspec = _n64_specs(bits)
    with exact_mode():
        want = jax.jit(lambda a, b: jax_build_pyramid(jspec, a, b))(
            jnp.asarray(pc1), jnp.asarray(pc2))
    got = build_pyramid(tspec, torch.from_numpy(pc1), torch.from_numpy(pc2))
    assert len(got) == len(want) == 7
    _assert_same(got, want, f"bits {bits}")
    assert [int(s.pc1_num_valid) for s in got][:2] == [252, 521]


def test_probe_sharding_keeps_the_fused_tables(monkeypatch):
    monkeypatch.setenv("HPL_FUSED_BUILD", "1")
    pc1, pc2 = (torch.from_numpy(p) for p in _n64_pair())
    spec, _ = _n64_specs(10)
    want = build_pyramid(spec, pc1, pc2)
    # one rank on the axis: nothing is split, the probes stay fused
    with tbuild.probe_sharding(make_mesh(axis_names=("lattice",))):
        _assert_same(build_pyramid(spec, pc1, pc2), want, "one rank")
    # a split probe: each cloud's probe runs apart, over its rank's taps
    # (a one-rank split here, whose all-gather is the rank's own part)
    probes = []
    real = tbuild._probe_local
    monkeypatch.setattr(tbuild, "_probe_local",
                        lambda v, q: probes.append(q[0].dim()) or real(v, q))
    monkeypatch.setattr(tbuild, "gather_parts", lambda local, n, shard: local[:n])
    token = tbuild._PROBE_SHARD.set(AxisShard(None, 0, 1))
    try:
        got = build_pyramid(spec, pc1, pc2)
    finally:
        tbuild._PROBE_SHARD.reset(token)
    _assert_same(got, want, "split probes")
    # blur at 7 scales and correlation at 5 (plus its inverse): per cloud
    assert probes == [2] * (7 * 2 + 5 * 2)


def _batch():
    rng = np.random.RandomState(0)
    pc1 = (rng.randn(2, 64, 3) * 2.0).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(2, 64, 3).astype(np.float32)
    v1 = np.ones((2, 64), bool)
    v2 = np.ones((2, 64), bool)
    v1[0, ::7] = False
    v2[1, 3::5] = False
    return pc1, pc2, v1, v2


CAPS5 = [320, 320, 256, 128, 128]


@functools.lru_cache(maxsize=None)
def _port_model():
    model = HPLFlowNetShallow(SFM5, device="cpu")
    return params_from_jax(seeded_jax_params(model, 0), model)


def test_batched_flow_forward_is_per_sample_flow_forward():
    pc1, pc2, v1, v2 = _batch()
    model, spec = _port_model(), make_lattice_spec(SFM5, CAPS5)
    got = batched_flow_forward(model, spec, pc1, pc2, v1, v2)
    want = torch.stack([flow_forward(model, spec, pc1[b], pc2[b], v1[b], v2[b])
                        for b in range(2)])
    assert got.shape == (2, 64, 3) and torch.isfinite(got).all()
    assert torch.equal(got, want)
    # missing masks are all True
    ones = np.ones((2, 64), bool)
    assert torch.equal(batched_flow_forward(model, spec, pc1, pc2),
                       batched_flow_forward(model, spec, pc1, pc2, ones, ones))


def test_batched_flow_forward_matches_jax():
    pc1, pc2, v1, v2 = _batch()
    model = _port_model()
    got = batched_flow_forward(model, make_lattice_spec(SFM5, CAPS5), pc1, pc2,
                               v1, v2).numpy()
    jspec = JaxSpec(d=3, scales=tuple(JaxScale(*r, capacity=c)
                                      for r, c in zip(SFM5, CAPS5)))
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  seeded_jax_params(HPLFlowNetShallow(SFM5, device="cpu"), 0))
    with exact_mode():
        want = np.asarray(jax.jit(lambda p, a, b, u, v: jax_batched_flow_forward(
            JaxShallow(scales_filter_map=SFM5), p, jspec, a, b, u, v))(
                tree, *(jnp.asarray(x) for x in (pc1, pc2, v1, v2))))
    assert got.shape == want.shape == (2, 64, 3)
    err = np.abs(got - want).max()
    assert err <= ATOL, err
    assert err / np.abs(want).max() <= MAX_REL
