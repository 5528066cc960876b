"""SPLATNet3D on the port's normal path, against its plain reference, on the CPU.

* ``lattice.build.build_scales``: each scale is the cloud's own
  ``_build_from_elevated`` and ``_neighbor_table`` of the points elevated
  at that scale, field for field; its keys, barycentric weights and blur
  table agree with the numpy oracle's (``tests/oracle/lattice_oracle.py``)
  up to the vertex ids' order; it marks the build's spans (no
  ``lattice.next``) and counts the vertices against the capacities.
* ``pipeline.segment_forward`` in float32 is the benchmark's reference
  (``flowbench/reference/splatnet3d.py``) within 1e-5 of its norm, on
  seeded weights with drawn BatchNorm statistics.
* In bfloat16 it is within ``BF16_TOL``, which the reference with float8
  operands and the reference without BatchNorm each miss by 10x or more.
* A cloud past a capacity: the dropped vertices are counted and read as
  absent (id -1), never as another vertex; the logits stay finite.
* A coarse lattice's long splat runs are summed in parts, to the sums of
  one walk of each run.  Every plan that reaches that split point in the
  two flow models' forward and train step is a pyramid scale's splat plan,
  and at the capacities of every flow cell of the benchmark none is split;
  in the segment cell BCLs 3-5 are.
* The forward's spans, and the config's refusal of the flow driver.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flowbench.configs import load_config
from flowbench.control import fp8
from flowbench.reference import splatnet3d as ref
from flowbench.traffic.generator import _pair_rng, frustum_pair, load_mix
from hplflownet_tpu_torch.lattice.build import (_build_from_elevated,
                                                _neighbor_table, _unpack_keys,
                                                build_scales)
from hplflownet_tpu_torch.lattice.geometry import elevate
from hplflownet_tpu_torch.lattice.offsets import neighborhood_offsets
from hplflownet_tpu_torch.models import MODELS, SPLATNet3D
from hplflownet_tpu_torch.ops import segment
from hplflownet_tpu_torch.pipeline import (flow_forward, make_lattice_spec,
                                           segment_forward)
from hplflownet_tpu_torch.train.step import loss_and_grad
from hplflownet_tpu_torch.utils.config import Config, postprocess
from hplflownet_tpu_torch.utils.profiling import tracing
from tests.oracle import lattice_oracle as oracle

CFG = load_config("splatnet3d")
SFM = CFG["scales_filter_map"]
N = 256
CAPS = [4 * N] * len(SFM)        # every corner its own vertex: no overflow
CPU = torch.device("cpu")
# bf16 products keep 8 significant bits, float8 e4m3 4: the control sits
# about 16x further off.  At 256 points, seeds 0-5: bf16 4.3e-3 to 5.9e-3,
# float8 7.0e-2 to 9.4e-2, the reference without BatchNorm 0.53 to 0.77.
BF16_TOL = 6.5e-3
PROGRAM = ("lattice.", "stencil.", "model.")
BENCH = json.loads((Path(__file__).resolve().parents[1] / "BENCHMARK.json").read_text())


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloud(seed, n=N):
    pts, _ = frustum_pair(_pair_rng(seed, 0), dict(load_mix("seg-98k"), num_points=n))
    return pts


def _model(params, dtype="float32"):
    model = SPLATNet3D(SFM, compute_dtype=dtype, device="cpu")
    model.load_state_dict(params, strict=True)
    return model


def _gap(got, want):
    got, want = got.double(), want.double()
    return float((got - want).norm() / want.norm())


def test_registered_with_the_published_widths():
    assert MODELS["SPLATNet3D"] is SPLATNet3D
    model = SPLATNet3D(SFM, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == CFG["num_parameters"]
    assert sum(b.numel() for b in model.buffers()) == CFG["num_bn_statistics"]
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        ref.param_shapes(CFG)
    # the flow driver's configs name the flow models only
    with pytest.raises(ValueError, match="unknown arch SPLATNet3D"):
        postprocess(Config(arch="SPLATNet3D", dataset="KITTI", data_root="x",
                           evaluate=False))


def test_build_scales_is_each_scale_built_alone_and_the_oracle():
    pts = _cloud(0)
    spec = make_lattice_spec(SFM, CAPS)
    x = torch.from_numpy(pts)
    valid = torch.ones(N, dtype=torch.bool)
    with tracing() as counters, profile(activities=[ProfilerActivity.CPU]) as prof:
        scales = build_scales(spec, x)
    offs = neighborhood_offsets(1, 3)
    assert (offs == oracle.stencil_np(1, 3)).all()
    for ss, sc in zip(spec.scales, scales):
        cl = _build_from_elevated(elevate(x, ss.scale), valid, ss.capacity)
        for name in sc.cloud._fields:
            a, b = getattr(sc.cloud, name), getattr(cl, name)
            if isinstance(a, tuple):
                assert all(torch.equal(u, v) for u, v in zip(a, b)), name
            else:
                assert torch.equal(a, b), name
        assert torch.equal(sc.blur_neighbors, _neighbor_table(cl, offs, 3))

        keys, bary, _ = oracle.keys_and_barycentric_np(pts, ss.scale)
        vkeys = _unpack_keys(cl.vkeys, 3, spec.coord_bits).numpy()
        ids = cl.lattice_offset.numpy()
        assert (ids >= 0).all() and int(cl.overflow) == 0
        np.testing.assert_array_equal(vkeys[ids], keys)
        np.testing.assert_allclose(cl.barycentric.numpy(), bary, atol=2e-5)
        tab = oracle.build_tables_np(keys, keys, 1, -1, -1)
        h = len(tab["pc1_keys"])
        assert int(cl.num_valid) == h
        # oracle ids are first-visit order; map them through the keys
        ours = {tuple(k): i for i, k in enumerate(vkeys[:h].tolist())}
        perm = np.array([ours[tuple(k)] for k in tab["pc1_keys"].tolist()])
        want = np.where(tab["pc1_blur_neighbors"] >= 0,
                        perm[np.clip(tab["pc1_blur_neighbors"], 0, None)], -1)
        np.testing.assert_array_equal(sc.blur_neighbors.numpy()[:, perm].T, want)

    assert counters.total("lattice.vertices") == sum(int(sc.cloud.num_valid)
                                                     for sc in scales)
    assert counters.total("lattice.rows") == sum(CAPS)
    spans = {(e.name, e.cpu_parent.name if e.cpu_parent else None)
             for e in prof.events() if e.name.startswith("lattice.")}
    want = {("lattice.build", None)}
    for i in range(len(SFM)):
        want |= {(f"lattice.scale{i}", "lattice.build"),
                 ("lattice.dedup", f"lattice.scale{i}"),
                 ("lattice.tables", f"lattice.scale{i}")}
    assert spans == want


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_forward_against_the_reference(seed):
    pts = _cloud(seed)
    params = ref.init_params(CFG, seed, CPU)
    spec = make_lattice_spec(SFM, CAPS)
    x = torch.from_numpy(pts)
    with torch.no_grad():
        want = ref.forward(CFG, CAPS, params, x)
        control = ref.forward(CFG, CAPS, params, x, q=fp8)
        no_bn = dict(params)
        for k, v in params.items():
            kind = k.rsplit(".", 1)[1]
            if kind in ("gamma", "beta", "mean", "var"):
                no_bn[k] = torch.full_like(v, {"gamma": 1.0, "var": 1.0 - ref.BN_EPS}
                                           .get(kind, 0.0))
        without_bn = ref.forward(CFG, CAPS, no_bn, x)

    got = segment_forward(_model(params), spec, pts)
    assert got.shape == (N, CFG["classes"]) and got.dtype == torch.float32
    assert _gap(got, want) < 1e-5
    gap16 = _gap(segment_forward(_model(params, "bfloat16"), spec, pts), want)
    assert gap16 < BF16_TOL
    assert _gap(control, want) > 10 * BF16_TOL
    assert _gap(without_bn, want) > 10 * BF16_TOL


def test_overflow_is_counted_not_aliased():
    pts = _cloud(2)
    caps = [64, 64, 64, 64, 32]
    spec = make_lattice_spec(SFM, caps)
    scales = build_scales(spec, torch.from_numpy(pts))
    uncapped = ref.build_scales(CFG, CAPS, torch.from_numpy(pts))
    for cap, sc, (full, _) in zip(caps, scales, uncapped):
        cl = sc.cloud
        assert int(cl.overflow) == full.num_valid - cap > 0
        assert int(cl.num_valid) == cap
        ids = cl.lattice_offset
        assert ids.max() < cap and (ids[full.offsets >= cap] == -1).all()
        # the kept vertices are the first ``cap`` keys in key order
        kept = full.offsets[full.offsets < cap]
        assert torch.equal(ids[full.offsets < cap].long(), kept)
    params = ref.init_params(CFG, 2, CPU)
    logits = segment_forward(_model(params), spec, pts)
    assert torch.isfinite(logits).all()
    assert _gap(logits, ref.forward(CFG, caps, params, torch.from_numpy(pts))) < 1e-5


def test_long_runs_are_summed_in_parts(monkeypatch):
    """A coarse lattice of a whole cloud: runs far longer than ``SPLIT``
    entries are summed in parts, then the parts; the same sums as one walk
    of each run (float32 and bf16 streams, with the densities)."""
    pts = torch.from_numpy(_cloud(5, 1024))
    cl = build_scales(make_lattice_spec([[0.1, 1, -1, -1]], [128]), pts)[0].cloud
    plan = cl.splat_plan
    m, t = plan.ids.shape[0], plan.start.shape[0]
    assert m >= segment.SPLIT * t and int((plan.end - plan.start).max()) > 4 * segment.SPLIT
    feats = torch.randn(pts.shape[0], 48, generator=torch.Generator().manual_seed(5))
    for dtype in (torch.float32, torch.bfloat16):
        cat = torch.cat([feats, cl.barycentric], dim=1).to(dtype)
        g = cat[plan.perm.long() // 4]
        rid = (plan.perm % 4).to(torch.int32)
        parts = segment.run_sums(g, rid, plan.start, plan.end, 48, True)
        with monkeypatch.context() as mp:
            mp.setattr(segment, "SPLIT", m + 1)
            whole = segment.run_sums(g, rid, plan.start, plan.end, 48, True)
        assert parts.shape == whole.shape == (t, 49)
        torch.testing.assert_close(parts, whole, rtol=1e-6, atol=1e-6)
        assert torch.equal(segment.weighted_reduce(True, plan, feats.to(dtype),
                                                   cl.barycentric), parts)


def test_forward_spans():
    pts = torch.from_numpy(_cloud(3, 64))
    model = SPLATNet3D(SFM, device="cpu")
    spec = make_lattice_spec(SFM, [256] * len(SFM))
    with tracing(), profile(activities=[ProfilerActivity.CPU]) as prof:
        segment_forward(model, spec, pts)
    got = set()
    for e in prof.events():
        if e.name.startswith(PROGRAM):
            p = e.cpu_parent
            while p is not None and not p.name.startswith(PROGRAM):
                p = p.cpu_parent
            got.add((e.name, None if p is None else p.name))
    want = {("model.forward", None), ("stencil.plans", "model.forward"),
            ("model.embed", "model.forward"), ("model.head", "model.forward")}
    for k in range(1, 6):
        want.add((f"model.bcl{k}", "model.forward"))
        want |= {(s, f"model.bcl{k}") for s in ("model.splat", "model.blur", "model.slice")}
    assert {g for g in got if not g[0].startswith("lattice.")} == want


def _splat_shapes(n, caps, d=3):
    """(M, T) of each scale's splat plan in a pyramid: (d + 1) entries a
    point onto the scale's capacity, scale s > 0 splatting the (padded)
    vertices of scale s - 1."""
    return [((d + 1) * r, c) for r, c in zip([n] + list(caps[:-1]), caps)]


@pytest.mark.parametrize("name", ["flagship", "shallow"])
def test_flow_models_split_only_the_pyramid_splat_plans(name, monkeypatch):
    """What reaches ``run_sums`` in a flow model's forward and train step:
    the pyramid's splat plans (the splats, and the slices' gradients through
    the same plans), so their shapes alone say whether a run is split."""
    cfg = load_config(name)
    sfm, caps = cfg["scales_filter_map"], cfg["capacities"]["128"]
    seen, run_sums = set(), segment.run_sums

    def recorder(g, rid, start, end, c, with_weights):
        seen.add((g.shape[0], start.shape[0]))
        return run_sums(g, rid, start, end, c, with_weights)
    monkeypatch.setattr(segment, "run_sums", recorder)
    pc1, pc2 = frustum_pair(_pair_rng(4, 0), dict(load_mix("train-8k"), num_points=128))
    model = MODELS[cfg["arch"]](sfm, device="cpu")
    spec = make_lattice_spec(sfm, caps)
    flow_forward(model, spec, pc1, pc2)
    assert seen == set(_splat_shapes(128, caps))
    seen.clear()
    batch = {"pc1": pc1[None], "pc2": pc2[None], "sf": (pc2 - pc1)[None],
             "valid1": np.ones((1, 128), bool), "valid2": np.ones((1, 128), bool)}
    loss_and_grad(model, spec, dict(model.named_parameters()), batch)
    assert seen == set(_splat_shapes(128, caps))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_only_the_segment_cell_splits_runs(cell):
    """At every cell's capacities, training included: no flow plan's runs
    average ``SPLIT`` entries (one ``rank_reduce`` launch a splat, bit for
    bit with the fused route); SPLATNet3D's BCLs 3-5 at 98304 points do."""
    w = {w["name"]: w for w in BENCH["workloads"]}[cell]
    cfg = load_config(w["config"])
    n = load_mix(w["traffic"])["num_points"]
    caps = cfg["capacities"][str(n)]
    segmenter = cfg["arch"] == "SPLATNet3D"
    # build_scales: every scale splats the N points
    shapes = [(4 * n, c) for c in caps] if segmenter else _splat_shapes(n, caps)
    split = [m >= segment.SPLIT * t for m, t in shapes]
    assert split == ([False, False, True, True, True] if segmenter
                     else [False] * len(caps)), shapes
