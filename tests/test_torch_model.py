"""The port's whole forward slice against the JAX package, on the CPU.

``flow_forward`` of hplflownet_tpu_torch (lattice pyramid + 7-scale
HPLFlowNet) is held against ``hplflownet_tpu.pipeline.flow_forward`` on the
same 64-point pair, in float32, with the JAX run in exact mode (window-free
probes, like the port).  Weights: the trained ``full7_params_d.pkl`` carried
across by ``params_from_jax``, and the port's seeded init.  The seeded case
is frozen in tests/data/torch_port_ref_n64.npz, which ``chip_smoke.py``
holds the card's kernel path against; a test here regenerates it and checks
the file.  Run ``python -m tests.test_torch_model`` to rewrite the file.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hplflownet_tpu.lattice import LatticeSpec as JaxSpec, ScaleSpec as JaxScale
from hplflownet_tpu.models import HPLFlowNet as JaxHPLFlowNet
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu.pipeline import flow_forward as jax_flow_forward
from hplflownet_tpu_torch.models import HPLFlowNet
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CAPS = [320, 576, 448, 192, 128, 64, 64]   # tests/test_e2e_parity.py:263
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PICKLE = os.path.join(ROOT, "training_runs", "full7_params_d.pkl")
REF_NPZ = os.path.join(ROOT, "tests", "data", "torch_port_ref_n64.npz")
REF_SEED = 0

# float32 flow: atol and max|err| / max|flow|.  Looser than what is reached
# (about 1e-4 abs with the trained weights) and tighter than the JAX
# suite's own oracle gate (atol 5e-3, max-rel 2e-2).
ATOL, MAX_REL = 1e-3, 5e-3


def _pair():
    rng = np.random.RandomState(11)
    pc1 = (rng.randn(64, 3) * 2.0).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(64, 3).astype(np.float32)
    return pc1, pc2


def _jax_flow(tree, pc1, pc2, dtype="float32"):
    spec = JaxSpec(d=3, scales=tuple(
        JaxScale(s, b, f, c, capacity=cap)
        for (s, b, f, c), cap in zip(SFM7, CAPS)))
    model = JaxHPLFlowNet(scales_filter_map=SFM7, compute_dtype=dtype)
    tree = jax.tree_util.tree_map(jnp.asarray, tree)
    with exact_mode():
        fwd = jax.jit(lambda p, a, b: jax_flow_forward(
            model, p, spec, a, b, adjoint_plans=False))
        return np.asarray(fwd(tree, jnp.asarray(pc1), jnp.asarray(pc2)))


def _torch_flow(tree, pc1, pc2, dtype="float32"):
    model = params_from_jax(tree, HPLFlowNet(SFM7, compute_dtype=dtype,
                                             device="cpu"))
    out = flow_forward(model, make_lattice_spec(SFM7, CAPS), pc1, pc2,
                       adjoint_plans=False)
    return out.numpy()


def _assert_close(got, want):
    assert got.shape == want.shape == (64, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= ATOL, err
    assert err / np.abs(want).max() <= MAX_REL


def reference_case():
    """The seeded-weight case frozen for the card: inputs and JAX flow."""
    pc1, pc2 = _pair()
    tree = seeded_jax_params(HPLFlowNet(SFM7, device="cpu"), REF_SEED)
    return dict(pc1=pc1, pc2=pc2, capacities=np.asarray(CAPS, np.int32),
                seed=np.asarray(REF_SEED), flow=_jax_flow(tree, pc1, pc2))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trained_weights_flow_matches_jax(dtype):
    with open(PICKLE, "rb") as fd:
        tree = pickle.load(fd)
    pc1, pc2 = _pair()
    want = _jax_flow(tree, pc1, pc2, dtype)
    got = _torch_flow(tree, pc1, pc2, dtype)
    if dtype == "float32":
        _assert_close(got, want)
    else:
        # bf16 activations round at the same places, but a sum taken in
        # another order can land one bf16 ulp apart and carry on (about
        # 3e-3 abs, 7e-3 max-rel reached)
        err = np.abs(got - want).max()
        assert err <= 1e-2 and err / np.abs(want).max() <= 2e-2, err


def test_frozen_reference_is_current_and_port_matches_it():
    case = reference_case()
    ref = np.load(REF_NPZ)
    for k in ("pc1", "pc2", "capacities", "seed"):
        np.testing.assert_array_equal(ref[k], case[k])
    # the frozen JAX output is what JAX computes today
    np.testing.assert_allclose(ref["flow"], case["flow"], rtol=0, atol=1e-6)
    tree = seeded_jax_params(HPLFlowNet(SFM7, device="cpu"), REF_SEED)
    _assert_close(_torch_flow(tree, case["pc1"], case["pc2"]), case["flow"])


def test_seeded_params_have_the_jax_tree_structure():
    """The port's parameter names and shapes are flax's, one for one."""
    pc1, pc2 = _pair()
    spec = JaxSpec(d=3, scales=tuple(
        JaxScale(s, b, f, c, capacity=cap)
        for (s, b, f, c), cap in zip(SFM7, CAPS)))
    from hplflownet_tpu.lattice import build_pyramid

    def init(a, b):
        return JaxHPLFlowNet(scales_filter_map=SFM7).init(
            jax.random.PRNGKey(0), a, b, build_pyramid(spec, a, b))
    shapes = jax.eval_shape(init, jnp.asarray(pc1), jnp.asarray(pc2))
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    tree = seeded_jax_params(HPLFlowNet(SFM7, device="cpu"), 3)
    got = {jax.tree_util.keystr(k): v.shape
           for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]}
    assert got == want


def test_params_from_jax_rejects_a_wrong_shape():
    model = HPLFlowNet(SFM7, device="cpu")
    tree = seeded_jax_params(model, 1)
    tree["params"]["bcn1"]["conv0_kernel"] = np.zeros((15, 67, 64), np.float32)
    with pytest.raises(ValueError, match="bcn1.conv0_kernel"):
        params_from_jax(tree, model)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        HPLFlowNet(SFM7)
    assert next(HPLFlowNet(SFM7, device="cpu").parameters()).device.type == "cpu"


if __name__ == "__main__":
    np.savez(REF_NPZ, **reference_case())
    print(f"wrote {REF_NPZ}")
