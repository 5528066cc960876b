"""The port's lattice-sharded forward (``parallel.lattice_sharded_forward``)
on the CPU: two gloo ranks in fresh interpreters
(``tools.dryrun_multiprocess``, mode "lattice"), tests/test_sharding.py's
setup (HPLFlowNetShallow, SFM5, one pair of n = 64 points, seed 3,
capacities [256, 256, 256, 128, 128]), float32, seeded weights.

* The sharded flow equals the port's unsharded ``flow_forward`` within
  atol 1e-5 (float32 matmuls of another row count may sum in another
  order on the CPU) and JAX's ``flow_forward`` on the same parameters
  within atol 1e-4 (test_sharding.py:67-78 holds JAX's sharded forward so).
* The tap-sharded tables (blur neighbours, correlation indices, the
  unique-offset correlation table) equal the unsharded build's exactly,
  for ring-1 stencils (15 taps; probes of 14, 15 and 65 queries) and
  ring-2 ones (65 taps; 64 and 65 queries and more): an odd tap count on
  two ranks takes the sentinel-padding path.
* Each rank's forward does under 0.75 of the unsharded forward's FLOPs
  (``torch.utils.flop_counter.FlopCounterMode``; 0.546 measured): the
  analogue of test_sharding.py:94-114's per-device count.  Splat, slice and
  the point-wise layers stay replicated.
* With one rank, or a mesh without a process group, the forward is
  ``pipeline.flow_forward`` bit for bit.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.lattice import LatticeSpec as JaxSpec, ScaleSpec as JaxScale
from hplflownet_tpu.models import HPLFlowNetShallow as JaxShallow
from hplflownet_tpu.pipeline import flow_forward as jax_flow_forward
from hplflownet_tpu_torch.lattice import build_pyramid
from hplflownet_tpu_torch.parallel import lattice_sharded_forward, make_mesh
from hplflownet_tpu_torch.params import params_to_jax
from hplflownet_tpu_torch.pipeline import flow_forward
from hplflownet_tpu_torch.tools import dryrun_multiprocess as dryrun
from torch.utils.flop_counter import FlopCounterMode

SFM5 = dryrun.DEFAULT_CASE["sfm"]
RING2 = [[s, 2, 2, 2] for s, *_ in SFM5]
CASE = dict(mode="lattice", num_points=64, capacities=[256, 256, 256, 128, 128],
            seed=3, global_batch=1)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _sharded(ring: int, procs: int = 2):
    """(run result, rank 0's saved flow and tables) of a lattice-sharded run."""
    import tempfile
    case = dict(CASE, sfm=SFM5 if ring == 1 else RING2)
    with tempfile.TemporaryDirectory() as tmp:
        res = dryrun.run(case, procs=procs, device="cpu", save_dir=tmp,
                         timeout=300)
        saved = torch.load(f"{tmp}/rank0.pt")
    return res, saved


def _unsharded(ring: int = 1):
    case = dict(dryrun.DEFAULT_CASE, **CASE, sfm=SFM5 if ring == 1 else RING2)
    model, spec, batch = dryrun.make_case(case, "cpu")
    return model, spec, batch["pc1"][0], batch["pc2"][0]


def test_sharded_forward_matches_unsharded_and_jax():
    res, saved = _sharded(1)
    assert res["mesh"] == {"lattice": 2} and res["backend"] == "gloo"
    model, spec, pc1, pc2 = _unsharded()
    want = flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    got = saved["flow"]
    assert got.shape == (64, 3) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-5)

    jspec = JaxSpec(d=3, scales=tuple(JaxScale(s.scale, s.blur_radius,
                                               s.corr_filter_radius,
                                               s.corr_corr_radius, s.capacity)
                                      for s in spec.scales))
    tree = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model))
    jflow = jax.jit(lambda p, a, b: jax_flow_forward(
        JaxShallow(scales_filter_map=SFM5), p, jspec, a, b))(
        tree, jnp.asarray(pc1), jnp.asarray(pc2))
    np.testing.assert_allclose(got.numpy(), np.asarray(jflow), rtol=0, atol=1e-4)


@pytest.mark.parametrize("ring", [1, 2], ids=["15_taps", "65_taps"])
def test_tap_sharded_tables_equal_unsharded(ring):
    _, saved = _sharded(ring)
    _, spec, pc1, pc2 = _unsharded(ring)
    with torch.inference_mode():
        scales = build_pyramid(spec, torch.from_numpy(pc1), torch.from_numpy(pc2),
                               adjoint_plans=False)
    assert len(saved["tables"]) == len(dryrun.TABLES) * len(scales)
    taps = {int(scales[0].pc1_blur_neighbors.shape[0])}
    for key, got in saved["tables"].items():
        s, name = key.split(".")
        want = getattr(scales[int(s)], name)
        assert torch.equal(got, want), key
        taps.add(int(want.shape[0]))
    assert (15 if ring == 1 else 65) in taps
    assert any(t % 2 for t in taps)        # the padded path ran


def test_per_rank_flops_below_three_quarters():
    res, _ = _sharded(1)
    model, spec, pc1, pc2 = _unsharded()
    with FlopCounterMode(display=False) as counter:
        flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    whole = counter.get_total_flops()
    assert res["flops"][0] == res["flops"][1]
    ratio = res["flops"][0] / whole
    assert 0.5 <= ratio < 0.75, (res["flops"], whole)


def test_one_rank_is_flow_forward_bit_for_bit():
    model, spec, pc1, pc2 = _unsharded()
    want = flow_forward(model, spec, pc1, pc2)
    # a mesh without a process group: nothing is split
    fn = lattice_sharded_forward(model, spec, make_mesh(axis_names=("lattice",)))
    assert torch.equal(fn(None, pc1, pc2), want)
    assert torch.equal(fn(dict(model.named_parameters()), pc1, pc2), want)
    # one gloo rank on the axis, in its own interpreter
    res, saved = _sharded(1, procs=1)
    assert res["mesh"] == {"lattice": 1}
    assert torch.equal(saved["flow"], want)
