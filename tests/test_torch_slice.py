"""The slice back to points (``ops.bcl.slice_to_points`` over
``kernels.slice.slice_points``).

On the CPU the wrapper runs its plain version, which is the composition the
BCL ran before the kernel: d + 1 clamped row gathers, float32 products and
sums in vertex order, then the slice bias and the cast to the compute
dtype.  The plain version and the autograd Function (forward and the
gradients of the table, the weights and the bias) are held to that
composition bit for bit; every model's forward and train step slices
through the wrapper once a BCL that slices.  ``cuda``-marked tests hold the
kernel to the plain version on a card by ``torch.equal`` and skip without
one; this module imports no JAX, so on a card ``python -m pytest
tests/test_torch_slice.py -m cuda --noconftest`` runs them.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hplflownet_tpu_torch.kernels import (count_launches, main_path_wrappers,
                                          plain_kernels)
from hplflownet_tpu_torch.kernels.slice import (MAX_VERTICES, _check_args,
                                                slice_points,
                                                slice_points_plain)
from hplflownet_tpu_torch.lattice import build_scales
from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
from hplflownet_tpu_torch.models import (HPLFlowNet, HPLFlowNetShallow,
                                         SPLATNet3D)
from hplflownet_tpu_torch.ops import bcl
from hplflownet_tpu_torch.ops.segment import _wr_forward
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import (flow_forward, make_lattice_spec,
                                           segment_forward)
from hplflownet_tpu_torch.tools.step_calls import recorded_calls
from hplflownet_tpu_torch.train import step as tstep

F32, BF16 = torch.float32, torch.bfloat16


# ---- the composition the BCL ran before the kernel --------------------------

def _old_slice_impl(blurred, bary, offsets):
    h = blurred.shape[0]
    out = None
    for r in range(offsets.shape[1]):
        safe = offsets[:, r].clamp(0, h - 1).long()
        term = bary[:, r, None] * blurred[safe].to(torch.float32)
        out = term if out is None else out + term
    return out


class _OldSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, blurred, out_barycentric, out_lattice_offset, plan):
        bary = torch.where(out_lattice_offset >= 0, out_barycentric, 0.0)
        ctx.plan = plan
        ctx.save_for_backward(blurred, out_barycentric, out_lattice_offset)
        return _old_slice_impl(blurred, bary, out_lattice_offset)

    @staticmethod
    def backward(ctx, g):
        blurred, bary, offsets = ctx.saved_tensors
        d_blurred = _wr_forward(False, ctx.plan, g.to(blurred.dtype),
                                bary).to(blurred.dtype)
        h = blurred.shape[0]
        d_bary = torch.stack(
            [torch.sum(g * blurred[offsets[:, r].clamp(0, h - 1).long()],
                       dim=1) for r in range(offsets.shape[1])], dim=1)
        d_bary = torch.where(offsets >= 0, d_bary, 0.0)
        return d_blurred, d_bary, None, None


def _old_composition(blurred, bary, offsets, plan, bias, out_dtype):
    sliced = _OldSlice.apply(blurred, bary, offsets, plan)
    if bias is not None:
        sliced = sliced + bias
    return sliced.to(out_dtype)


# ---- inputs -------------------------------------------------------------------

def _ids(n, h, d1=4, seed=0):
    """(N, d1) ids and weights with every kind of absent vertex: id -1 with
    a nonzero weight (a vertex dropped past capacity), invalid points (all
    -1, zero and nonzero weights), and the table's last row."""
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, h, (n, d1), generator=g, dtype=torch.int32)
    bary = torch.rand(n, d1, generator=g)
    bary = bary / bary.sum(1, keepdim=True)
    ids[torch.rand(n, d1, generator=g) < 0.1] = -1
    ids[3], ids[5] = -1, -1
    bary[5] = 0.0
    ids[7, 2] = h - 1
    ids[8] = h - 1
    return ids, bary


def _table(h, c, dtype, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(h, c, generator=g).to(dtype)


CASES = [(dt, c, with_bias) for dt in (BF16, F32) for c in (3, 64, 68, 960, 1024)
         for with_bias in (True, False)]


@pytest.mark.parametrize("dt,c,with_bias", CASES)
def test_plain_version_is_the_old_composition_bit_for_bit(dt, c, with_bias):
    h, n = 57, 203
    ids, bary = _ids(n, h)
    table = _table(h, c, dt)
    bias = torch.randn(c) if with_bias else None
    want = _old_composition(table, bary, ids, None, bias, dt)
    got = slice_points_plain(table, bary, ids, bias, dt)
    assert got.dtype == dt and torch.equal(got, want)
    # the invalid points: the bias alone, or zero
    assert torch.equal(got[3], (bias if with_bias else torch.zeros(c)).to(dt))
    # float32 out of a bf16 table (the JAX function's result dtype)
    assert torch.equal(slice_points_plain(table, bary, ids, bias),
                       _old_composition(table, bary, ids, None, bias, F32))


def _lattice(n=160, cap=96, seed=0):
    """A real cloud's finest scale, capacity below its vertex count (valid
    points whose vertex overflowed) and a quarter of the points invalid."""
    pts = torch.from_numpy(synthetic_frustum_clouds(1, n, seed=seed)[0][0])
    valid = torch.arange(n) % 4 != 0
    spec = make_lattice_spec([[1.0, 1, -1, -1]], [cap])
    sc = build_scales(spec, pts, valid)[0]
    assert int(sc.cloud.overflow) > 0
    return sc.cloud, cap


@pytest.mark.parametrize("dt,with_bias,bary_grad", [
    (dt, with_bias, bary_grad) for dt in (BF16, F32) for with_bias in (True, False)
    for bary_grad in (True, False)])
def test_function_gradients_are_the_old_composition_bit_for_bit(dt, with_bias,
                                                               bary_grad):
    """The table's, the weights' and the bias's gradients; the models' steps
    ask for the table's and the bias's alone (the weights come from the
    lattice), where the Function keeps only the weights for its backward."""
    cl, h = _lattice()
    c = 48
    g = torch.Generator().manual_seed(2)
    table0 = torch.randn(h, c, generator=g).to(dt)
    bias0 = torch.randn(c, generator=g)
    cot = torch.randn(cl.barycentric.shape[0], c, generator=g).to(dt)
    names = (("y", "d_blurred") + (("d_bary",) if bary_grad else ())
             + (("d_bias",) if with_bias else ()))
    got = {}
    for name, fn in (("old", _old_composition), ("new", bcl.slice_to_points)):
        table = table0.clone().requires_grad_(True)
        bary = cl.barycentric.clone().requires_grad_(bary_grad)
        bias = bias0.clone().requires_grad_(True) if with_bias else None
        y = fn(table, bary, cl.lattice_offset, cl.splat_plan, bias, dt)
        leaves = ((table,) + ((bary,) if bary_grad else ())
                  + ((bias,) if with_bias else ()))
        got[name] = (y.detach(),) + torch.autograd.grad(y, leaves, cot)
    assert len(got["new"]) == len(names)
    for what, old, new in zip(names, got["old"], got["new"]):
        assert new.dtype == old.dtype, (what, new.dtype, old.dtype)
        assert torch.equal(new, old), (what, (new.float() - old.float()).abs().max())


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    ids, bary = _ids(50, 20)
    table, bias = _table(20, 64, BF16), torch.randn(64)
    before = slice_points.launches
    assert torch.equal(slice_points(table, bary, ids, bias, BF16),
                       slice_points_plain(table, bary, ids, bias, BF16))
    with plain_kernels():
        assert torch.equal(slice_points(table, bary, ids),
                           slice_points_plain(table, bary, ids))
    assert slice_points.launches == before
    assert main_path_wrappers()["slice_points"] is slice_points


def test_argument_checks_reject_what_the_kernel_does_not_take():
    ids, bary = _ids(16, 10)
    table, bias = _table(10, 8, BF16), torch.randn(8)
    _check_args(table, bary, ids, bias, BF16)
    _check_args(table.float(), bary, ids, None, F32)
    with pytest.raises(TypeError):
        _check_args(table.half(), bary, ids, bias, BF16)
    with pytest.raises(TypeError):
        _check_args(table, bary, ids, bias, torch.float16)
    with pytest.raises(TypeError):
        _check_args(table, bary, ids.long(), bias, BF16)
    with pytest.raises(ValueError):
        _check_args(table[:0], bary, ids, bias, BF16)
    with pytest.raises(ValueError):
        _check_args(table, bary.double(), ids, bias, BF16)
    with pytest.raises(ValueError):
        _check_args(table, bary[:, :3], ids, bias, BF16)
    with pytest.raises(ValueError):
        wide = torch.zeros(16, MAX_VERTICES + 1, dtype=torch.int32)
        _check_args(table, wide.float(), wide, bias, BF16)
    with pytest.raises(ValueError):
        _check_args(table, bary, ids, bias[:7], BF16)
    with pytest.raises(ValueError):
        _check_args(table, bary, ids, bias.to(BF16), BF16)
    with pytest.raises(ValueError):
        _check_args(table[:, ::2], bary, ids, None, BF16)


# ---- every model slices through the wrapper, once a slicing BCL -----------

def _slice_calls(fn):
    with recorded_calls() as calls:
        out = fn()
    return out, [(tuple(a[0].shape), a[3] is not None, kw, out_.dtype)
                 for name, a, kw, out_ in calls if name == "slice_points"]


@pytest.mark.parametrize("arch", ["splatnet3d", "flagship", "shallow"])
def test_slices_per_forward_and_step(arch):
    """5 / 7 / 5 slices a forward (SPLATNet3D / flagship / shallow), the
    same in a train step (the backward slices nothing); on the CPU
    ``count_launches`` counts none of them."""
    if arch == "splatnet3d":
        pts = synthetic_frustum_clouds(1, 64, seed=0)[0][0]
        sfm = chip_smoke.SEG_SFM
        caps = [256, 256, 256, 128, 128]
        model = SPLATNet3D(sfm, device="cpu")
        spec = make_lattice_spec(sfm, caps)
        (_, calls), launches = count_launches(
            lambda: _slice_calls(lambda: segment_forward(model, spec, pts)))
        assert [c for c, *_ in calls] == list(zip(caps, (64, 128, 256, 256, 256)))
        assert not any(b for _, b, _, _ in calls)        # no slice bias
        assert launches["slice_points"] == 0
        return
    cls, sfm, n = ((HPLFlowNet, chip_smoke.SFM7, 7) if arch == "flagship"
                   else (HPLFlowNetShallow, chip_smoke.SFM5, 5))
    ref = np.load(chip_smoke.REF_NPZ if arch == "flagship"
                  else chip_smoke.SHALLOW_REF_NPZ)
    caps = [int(c) for c in ref["capacities"]]
    model = params_from_jax(seeded_jax_params(cls(sfm, device="cpu"),
                                              int(ref["seed"])),
                            cls(sfm, device="cpu"))
    spec = make_lattice_spec(sfm, caps)
    pc1, pc2 = ref["pc1"].reshape(-1, 3), ref["pc2"].reshape(-1, 3)
    (_, calls), launches = count_launches(lambda: _slice_calls(
        lambda: flow_forward(model, spec, pc1, pc2, adjoint_plans=False)))
    assert len(calls) == n and all(b for _, b, _, _ in calls)
    assert launches["slice_points"] == 0
    batch = dict(pc1=ref["pc1"].reshape(1, -1, 3), pc2=ref["pc2"].reshape(1, -1, 3),
                 sf=(ref["pc2"] - ref["pc1"]).reshape(1, -1, 3))
    m = batch["pc1"].shape[1]
    batch.update(valid1=np.ones((1, m), bool), valid2=np.ones((1, m), bool))
    _, step_calls = _slice_calls(lambda: tstep.loss_and_grad(
        model, spec, dict(model.named_parameters()), batch))
    assert len(step_calls) == n


# ---- on a card --------------------------------------------------------------

# (N, H, C, bias): SPLATNet3D's five slices and the flagship decoder's
# seven at 98304 points (capacities of flowbench's configurations), and
# the flagship's coarsest slices at 8192 points
CARD_SHAPES = (
    [(98304, h, c, False) for h, c in zip(chip_smoke.SEG_CAPACITIES,
                                           (64, 128, 256, 256, 256))]
    + [(n, h, c, True) for n, h, c in zip(
        (98304, 90752, 72448, 20992, 4736, 1152, 384),
        (90752, 72448, 20992, 4736, 1152, 384, 128),
        (1024, 512, 256, 256, 128, 128, 128))]
    + [(896, 256, 128, True), (256, 128, 128, True)])


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    return torch.device("cuda")


def _bits(t):
    return t.view(torch.int16) if t.dtype == BF16 else t.view(torch.int32)


@pytest.mark.cuda
def test_kernel_equals_the_plain_version_on_the_card(card):
    for i, (n, h, c, with_bias) in enumerate(CARD_SHAPES):
        ids, bary = _ids(n, h, seed=i)
        ids, bary = ids.to(card), bary.to(card)
        table = _table(h, c, BF16, seed=i).to(card)
        bias = torch.randn(c).to(card) if with_bias else None
        before = slice_points.launches
        got = slice_points(table, bary, ids, bias, BF16)
        again = slice_points(table, bary, ids, bias, BF16)
        assert slice_points.launches == before + 2
        want = slice_points_plain(table, bary, ids, bias, BF16)
        assert torch.equal(_bits(got), _bits(again)), (n, h, c)
        assert torch.equal(got, want), (n, h, c)
    # the other dtypes, narrow and ragged rows, absent vertices
    for c in (3, 64, 68, 960, 1024):
        ids, bary = _ids(4099, 700, seed=c)
        ids, bary = ids.to(card), bary.to(card)
        for dt in (BF16, F32):
            table = _table(700, c, dt, seed=c).to(card)
            for bias in (None, torch.randn(c).to(card)):
                for out_dtype in (BF16, F32):
                    got = slice_points(table, bary, ids, bias, out_dtype)
                    want = slice_points_plain(table, bary, ids, bias, out_dtype)
                    assert torch.equal(got, want), (c, dt, out_dtype)
    # a table and output that are not 16-byte aligned take narrower chunks
    table = _table(701, 64, BF16).to(card).flatten()[1:1 + 700 * 64].view(700, 64)
    assert table.data_ptr() % 16 != 0
    got = slice_points(table, bary, ids)
    assert torch.equal(got, slice_points_plain(table, bary, ids))


@pytest.mark.cuda
def test_models_launch_the_kernel_once_a_slice(card):
    """5 launches a SPLATNet3D forward and 7 a flagship forward, each call
    equal to the plain version on its own arguments; none under
    ``plain_kernels()``."""
    pts = synthetic_frustum_clouds(1, 8192, seed=0)[0][0]
    seg = chip_smoke._segment_model(card)
    seg_spec = make_lattice_spec(chip_smoke.SEG_SFM, chip_smoke.SEG_CAPACITIES)
    flag = HPLFlowNet(chip_smoke.SFM7, compute_dtype="bfloat16", device=card)
    params_from_jax(seeded_jax_params(flag, 0), flag)
    flag_spec = make_lattice_spec(chip_smoke.SFM7, chip_smoke.CAPACITIES)
    pc1, pc2 = synthetic_frustum_clouds(1, chip_smoke.NUM_POINTS, seed=0)
    wrappers = {"slice_points": slice_points}
    for fwd, n in ((lambda: segment_forward(seg, seg_spec, pts), 5),
                   (lambda: flow_forward(flag, flag_spec, pc1[0], pc2[0],
                                         adjoint_plans=False), 7)):
        with recorded_calls() as calls:
            _, launches = count_launches(fwd, wrappers)
        assert launches == {"slice_points": n}
        sliced = [(a, kw, out) for name, a, kw, out in calls
                  if name == "slice_points"]
        assert len(sliced) == n
        for a, kw, out in sliced:
            assert torch.equal(out, slice_points_plain(*a, **kw))
        with plain_kernels():
            _, launches = count_launches(fwd, wrappers)
        assert launches == {"slice_points": 0}
