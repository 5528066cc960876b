"""The dense layers (``ops.bcl.dense`` over ``kernels.dense.dense_gemm``).

On the CPU the wrapper runs its plain version, which is the composition the
layers ran before the kernel: a float32 product of operands rounded to the
compute dtype, then the bias, the activation and the cast, each a pass of
its own.  The autograd Function's forward and hand-written backward are
held to that composition under autograd bit for bit, at every (K, N,
activation, output dtype, input dtype) the two models call; whole forwards
and train steps of both models at 64 points are held to the frozen JAX
references.  ``cuda``-marked tests hold the kernel to the plain version on
a card (run: ``python -m pytest tests/test_torch_dense.py -m cuda`` there)
and skip without one.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from hplflownet_tpu_torch.kernels import (count_launches, main_path_wrappers,
                                          plain_kernels)
from hplflownet_tpu_torch.kernels.dense import (_check_args, dense_gemm,
                                                dense_gemm_plain, gemm_input,
                                                gemm_weight)
from hplflownet_tpu_torch.ops import bcl
from hplflownet_tpu_torch.models import HPLFlowNet, HPLFlowNetShallow
from hplflownet_tpu_torch.ops.bcl import LEAKY_RATE, activation, dense
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.tools.step_calls import recorded_calls
from hplflownet_tpu_torch.train import step as tstep

F32, BF16 = torch.float32, torch.bfloat16
LEAKY, RELU = LEAKY_RATE, 0.0

# (K, N, act_slope, out dtype, input dtype): every dense layer of the two
# models (flagship and shallow, bf16 compute), and ReLU where a model is
# built without the leaky flag
MODEL_LAYERS = {
    "conv1.0": (3, 32, LEAKY, BF16, BF16),
    "conv1.1": (32, 32, LEAKY, BF16, BF16),
    "conv1.2": (32, 64, LEAKY, BF16, BF16),
    "bcn1_.conv1": (1024, 1024, None, BF16, BF16),
    "bcn2_.conv1": (512, 512, None, BF16, BF16),
    "bcn3_.conv1": (256, 256, None, BF16, BF16),
    "bcn5_.conv1": (128, 128, None, BF16, BF16),
    "corr.corr1": (32, 32, LEAKY, BF16, F32),
    "corr.blur0": (480, 64, LEAKY, BF16, BF16),
    "corr.blur1": (64, 64, None, BF16, BF16),
    "shallow corr.blur0": (480, 32, None, BF16, F32),
    "refine.0": (36, 64, LEAKY, BF16, BF16),
    "refine.1": (64, 64, LEAKY, BF16, BF16),
    "corr3_refine.0": (32, 64, LEAKY, BF16, BF16),
    "conv2": (1024, 1024, LEAKY, BF16, BF16),
    "shallow conv2": (128, 1024, LEAKY, BF16, BF16),
    "conv3": (1024, 512, LEAKY, BF16, BF16),
    "conv4": (512, 3, None, F32, BF16),
    "relu conv1.0": (3, 32, RELU, BF16, BF16),
    "relu conv2": (1024, 1024, RELU, BF16, BF16),
    "float32 compute": (36, 64, LEAKY, F32, F32),
}


def _composition(x, k, b, slope, out_dtype, dt):
    """The layers' code before the kernel: dense, + bias, activation, cast."""
    y = x.to(dt).to(F32) @ k.to(dt).to(F32) + b
    if slope is not None:
        y = activation(y, slope != 0.0)
    return y.to(out_dtype)


def _case(k, n, in_dtype, m=37, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(m, k, generator=g).to(in_dtype)
    w = torch.randn(k, n, generator=g) / k ** 0.5
    b = torch.randn(n, generator=g) * 0.1
    return x, w, b


@pytest.mark.parametrize("layer", sorted(MODEL_LAYERS))
def test_dense_is_the_old_composition_bit_for_bit(layer):
    k, n, slope, out_dtype, in_dtype = MODEL_LAYERS[layer]
    dt = F32 if layer == "float32 compute" else BF16
    x0, w0, b0 = _case(k, n, in_dtype)
    cot = torch.randn(x0.shape[0], n, generator=torch.Generator().manual_seed(1))
    got = {}
    for name, fn in (("old", _composition), ("new", dense)):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = fn(x, w, b, slope, out_dtype, dt)
        y.backward(cot.to(y.dtype))
        got[name] = (y.detach(), x.grad, w.grad, b.grad)
    for what, old, new in zip(("y", "dx", "dw", "db"), got["old"], got["new"]):
        assert new.dtype == old.dtype, (what, new.dtype, old.dtype)
        assert torch.equal(new, old), (what, (new.float() - old.float()).abs().max())


@pytest.mark.parametrize("layer", sorted(MODEL_LAYERS))
def test_backward_from_the_kept_weight_is_the_old_composition(layer, monkeypatch):
    """The card's route through the Function: the forward keeps the
    kernel's transposed, rounded (and K-padded) weight and the backward
    reads it.  On the CPU the wrapper still runs its plain version, so the
    kept weight is the only change, and the gradients stay bit for bit."""
    monkeypatch.setattr(bcl, "uses_kernel", lambda x: True)
    k, n, slope, out_dtype, in_dtype = MODEL_LAYERS[layer]
    dt = F32 if layer == "float32 compute" else BF16
    x0, w0, b0 = _case(k, n, in_dtype, seed=2)
    cot = torch.randn(x0.shape[0], n, generator=torch.Generator().manual_seed(3))
    got = {}
    for name, fn in (("old", _composition), ("new", dense)):
        x, w, b = (t.clone().requires_grad_(True) for t in (x0, w0, b0))
        y = fn(x, w, b, slope, out_dtype, dt)
        y.backward(cot.to(y.dtype))
        got[name] = (y.detach(), x.grad, w.grad, b.grad)
    for what, old, new in zip(("y", "dx", "dw", "db"), got["old"], got["new"]):
        assert new.dtype == old.dtype, (what, new.dtype, old.dtype)
        assert torch.equal(new, old), (what, (new.float() - old.float()).abs().max())


@pytest.mark.parametrize("k", [3, 8, 32, 36, 480])
def test_operands_pad_k_to_a_multiple_of_8_with_zeros(k):
    """The kernel's operands: K rounded up to 8 (a bf16 row pitch of whole
    16 bytes, which TMA asks) with zero channels, the weight transposed,
    both contiguous and 16-byte aligned, even from an unaligned view."""
    kp = -(-k // 8) * 8
    x, w, _ = _case(k, 24, F32, m=11)
    view = torch.cat([torch.zeros(1), x.flatten()])[1:].view(11, k)
    for src in (x, view, x.to(BF16)):
        xc = gemm_input(src, BF16)
        assert xc.shape == (11, kp) and xc.dtype == BF16 and xc.is_contiguous()
        assert xc.data_ptr() % 16 == 0
        assert torch.equal(xc[:, :k], src.to(BF16))
        assert not xc[:, k:].any()
    wt = gemm_weight(w, BF16)
    assert wt.shape == (24, kp) and wt.dtype == BF16 and wt.is_contiguous()
    assert torch.equal(wt[:, :k], w.t().to(BF16)) and not wt[:, k:].any()
    assert torch.equal(gemm_weight(w, F32)[:, :k], w.t())


def test_dense_without_bias_or_weight_gradient():
    x, w, b = _case(64, 32, BF16)
    x.requires_grad_(True)
    y = dense(x, w, None, LEAKY, BF16, BF16)
    y.float().sum().backward()
    want = _composition(x.detach(), w, torch.zeros(32), LEAKY, BF16, BF16)
    assert torch.equal(y.detach(), want)
    assert x.grad is not None and x.grad.dtype == BF16 and w.grad is None


def test_wrapper_runs_the_plain_version_on_cpu_and_counts_no_launch():
    x, w, b = _case(36, 64, F32)
    before = (dense_gemm.launches, dense_gemm.rows)
    for slope in (None, RELU, LEAKY):
        for out_dtype in (F32, BF16):
            assert torch.equal(dense_gemm(x, w, b, slope, out_dtype),
                               _composition(x, w, b, slope, out_dtype, BF16))
            with plain_kernels():
                assert torch.equal(dense_gemm(x, w, None, slope, out_dtype),
                                   dense_gemm_plain(x, w, None, slope, out_dtype))
    assert (dense_gemm.launches, dense_gemm.rows) == before
    assert main_path_wrappers()["dense_gemm"] is dense_gemm


def test_argument_checks_reject_what_the_kernel_does_not_take():
    x, w, b = _case(8, 4, BF16)
    with pytest.raises(TypeError):
        _check_args(x, w, b, torch.float16, BF16)
    with pytest.raises(TypeError):
        _check_args(x.int(), w, b, BF16, BF16)
    with pytest.raises(ValueError):
        _check_args(x, w[:7], b, BF16, BF16)
    with pytest.raises(ValueError):
        _check_args(x, w, b.double(), BF16, BF16)
    with pytest.raises(ValueError):
        _check_args(x, w, b[:3], BF16, BF16)
    _check_args(x, w, b, BF16, F32)


# ---- whole models at 64 points, against the frozen JAX references ---------

def _dense_calls(model, caps, sfm, pc1, pc2):
    """The forward's flow and its dense_gemm calls (K, N, output dtype)."""
    with recorded_calls() as calls:
        flow = flow_forward(model, make_lattice_spec(sfm, caps), pc1, pc2,
                            adjoint_plans=False)
    dense_calls = [(a[0].shape[1], a[1].shape[1], str(out.dtype))
                   for name, a, kw, out in calls if name == "dense_gemm"]
    return flow, dense_calls


@pytest.mark.parametrize("arch", ["flagship", "shallow"])
def test_whole_forward_and_train_step_match_the_frozen_references(arch):
    if arch == "flagship":
        ref = np.load(chip_smoke.REF_NPZ)
        train_ref = np.load(chip_smoke.TRAIN_REF_NPZ)
        # conv1 3 x 2 clouds, the encoder's pointwise convs 7 x 2, the
        # decoder's 7, the correlations' 3 x 5, the head's 3
        sfm, cls, n_dense = chip_smoke.SFM7, HPLFlowNet, 45
    else:
        ref = train_ref = np.load(chip_smoke.SHALLOW_REF_NPZ)
        # conv1 3 x 2, the correlations' 3 x 1, the refine MLPs 3 x 3, the
        # head's 3 (its encoder and decoder BCLs have no pointwise conv)
        sfm, cls, n_dense = chip_smoke.SFM5, HPLFlowNetShallow, 21
    caps = [int(c) for c in ref["capacities"]]
    model = params_from_jax(seeded_jax_params(cls(sfm, device="cpu"),
                                              int(ref["seed"])),
                            cls(sfm, device="cpu"))
    flow, calls = _dense_calls(model, caps, sfm, ref["pc1"].reshape(-1, 3),
                               ref["pc2"].reshape(-1, 3))
    # every dense product of the forward goes through the wrapper, once
    assert len(calls) == n_dense, calls
    assert calls[-1] == (512, 3, "torch.float32")       # the flow head
    err = np.abs(flow.numpy() - ref["flow"]).max()
    assert err <= 1e-3 and err / np.abs(ref["flow"]).max() <= 5e-3, err
    batch = {k: train_ref[k].reshape(1, -1, 3) for k in ("pc1", "pc2", "sf")}
    n = batch["pc1"].shape[1]
    batch.update(valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))
    loss, overflow, grads = tstep.loss_and_grad(
        model, make_lattice_spec(sfm, caps), dict(model.named_parameters()),
        batch)
    assert int(overflow) == 0
    rows = chip_smoke.check_train_reference(train_ref, float(loss), grads)
    assert [r["against"] for r in rows] == ["jax", "exact"]


# ---- on a card --------------------------------------------------------------

CARD_SHAPES = [
    # (M, K, N): a ragged M at every (K, N) of the two models, the
    # widest rows of the main path, and the correlation's h1 x 15 at 98304
    (4097, 3, 32), (4097, 32, 32), (4097, 32, 64), (4097, 36, 64),
    (4097, 64, 64), (4097, 128, 128), (4097, 128, 1024), (4097, 256, 256),
    (4097, 480, 32), (4097, 480, 64), (4097, 512, 3), (4097, 512, 512),
    (4097, 1024, 512), (4097, 1024, 1024), (98304, 1024, 1024),
    (90752, 1024, 1024), (314880, 32, 32), (131, 100, 200), (700, 3, 300),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run: python3 chip_smoke.py)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_kernel_matches_the_plain_version_on_the_card(card):
    g = torch.Generator().manual_seed(0)
    for m, k, n in CARD_SHAPES:
        x = torch.randn(m, k, generator=g).to(card, BF16)
        w = (torch.randn(k, n, generator=g) / k ** 0.5).to(card)
        b = (torch.randn(n, generator=g) * 0.1).to(card)
        for slope, out_dtype in ((LEAKY, BF16), (None, BF16), (RELU, F32),
                                 (None, F32)):
            got = dense_gemm(x, w, b, slope, out_dtype)
            assert torch.equal(got, dense_gemm(x, w, b, slope, out_dtype))
            want = dense_gemm_plain(x, w, b, slope, out_dtype)
            d = float((got.float() - want.float()).abs().max()
                      / want.float().abs().max())
            # a bf16 output lands within an ulp; float32 sums in another order
            assert d <= (chip_smoke.CALL_TOL["bf16"] if out_dtype == BF16
                         else chip_smoke.CALL_TOL["f32"]), (m, k, n, slope, d)
    # a float32 input (cast by the wrapper) and float32 operands
    x = torch.randn(3000, 480, generator=g).to(card)
    w = torch.randn(480, 64, generator=g).to(card) / 22
    got = dense_gemm(x, w, None, LEAKY, BF16)
    want = dense_gemm_plain(x, w, None, LEAKY, BF16)
    assert float((got.float() - want.float()).abs().max()
                 / want.float().abs().max()) <= chip_smoke.CALL_TOL["bf16"]
    got = dense_gemm(x, w, None, LEAKY, F32, F32)
    want = dense_gemm_plain(x, w, None, LEAKY, F32, F32)
    assert float((got - want).abs().max() / want.abs().max()) <= 1e-5
    # float32 operands at each of the SIMT route's tile widths (32, 64, 128
    # columns), ragged rows and columns, K = 3 and K not a multiple of 8
    for m, k, n in ((4097, 3, 32), (4097, 36, 64), (4097, 512, 3),
                    (4097, 1024, 1024), (131, 100, 200), (700, 3, 300)):
        x = torch.randn(m, k, generator=g).to(card)
        w = (torch.randn(k, n, generator=g) / k ** 0.5).to(card)
        b = (torch.randn(n, generator=g) * 0.1).to(card)
        for slope, out_dtype in ((LEAKY, F32), (RELU, BF16), (None, F32)):
            got = dense_gemm(x, w, b, slope, out_dtype, F32)
            want = dense_gemm_plain(x, w, b, slope, out_dtype, F32)
            d = float((got.float() - want.float()).abs().max()
                      / want.float().abs().max())
            assert d <= (1e-5 if out_dtype == F32
                         else chip_smoke.CALL_TOL["bf16"]), (m, k, n, slope, d)


@pytest.mark.cuda
def test_flagship_forward_launches_the_kernel_once_per_dense_product(card):
    sfm = chip_smoke.SFM7
    caps = chip_smoke.CAPACITIES
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    pc1, pc2 = synthetic_frustum_clouds(1, chip_smoke.NUM_POINTS, seed=0)
    model = HPLFlowNet(sfm, compute_dtype="bfloat16", device=card)
    params_from_jax(seeded_jax_params(model, 0), model)
    spec = make_lattice_spec(sfm, caps)

    def fwd():
        with torch.inference_mode():
            out = flow_forward(model, spec, pc1[0], pc2[0], adjoint_plans=False)
        torch.cuda.synchronize()
        return out
    flow, launches = count_launches(fwd, {"dense_gemm": dense_gemm})
    assert launches["dense_gemm"] == 45      # one per dense product
    with plain_kernels():
        plain, launches = count_launches(fwd, {"dense_gemm": dense_gemm})
    assert launches["dense_gemm"] == 0
    rel = float((flow - plain).norm() / plain.norm())
    assert rel <= 5e-2, rel
