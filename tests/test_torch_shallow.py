"""The port's 5-scale HPLFlowNetShallow against the JAX package, on the CPU.

The forward and the train step's loss and gradients at n = 64, SFM5,
capacities [320, 320, 256, 128, 128] (the setup of
tests/test_e2e_parity.py), float32, seeded weights, the JAX side in
``exact_mode()``.  Tolerances as for the flagship:

* flow: atol 1e-3, max-rel 5e-3 against JAX, and the numpy oracle's gate
  (atol 5e-3, max-rel 2e-2; ``shallow_oracle_forward``);
* gradients per leaf, as max|port - JAX| over max|JAX|: 1e-4 against JAX
  with exact segment sums, 5e-2 (median 5e-3) against JAX as it is (its
  float32 ``segment._combine``; tests/test_torch_train.py says why).

The case is frozen in tests/data/torch_port_shallow_ref_n64.npz (the flow,
and per leaf the gradient's norm and seeded dot products), which
``chip_smoke.py`` holds the card's kernels against; a test here
regenerates it.  Run ``python -m tests.test_torch_shallow`` to rewrite it.
"""

import contextlib
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hplflownet_tpu.lattice import (LatticeSpec as JaxSpec, ScaleSpec as JaxScale,
                                    build_pyramid as jax_build_pyramid)
from hplflownet_tpu.models import HPLFlowNetShallow as JaxShallow
from hplflownet_tpu.ops import segment as jseg
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu.pipeline import flow_forward as jax_flow_forward
from hplflownet_tpu.train.step import _batched_loss as jax_batched_loss
from hplflownet_tpu_torch.models import MODELS, HPLFlowNet, HPLFlowNetShallow, get_model
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.train import step as tstep

try:
    from test_e2e_parity import shallow_oracle_forward
    from test_torch_train import _exact_wr_forward, _leaf_errors
except ImportError:          # run as ``python -m tests.test_torch_shallow``
    from tests.test_e2e_parity import shallow_oracle_forward
    from tests.test_torch_train import _exact_wr_forward, _leaf_errors

SFM5 = chip_smoke.SFM5
CAPS = [320, 320, 256, 128, 128]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(ROOT, chip_smoke.SHALLOW_REF_NPZ)
REF_SEED = 0
ATOL, MAX_REL = 1e-3, 5e-3
LIVE_TOL, LIVE_MEDIAN_TOL, EXACT_TOL = 5e-2, 5e-3, 1e-4


def _pair():
    """tests/test_e2e_parity.py's ``_setup`` pair."""
    rng = np.random.RandomState(0)
    pc1 = (rng.randn(64, 3) * 2.0).astype(np.float32)
    pc2 = pc1 + 0.05 * rng.randn(64, 3).astype(np.float32)
    return pc1, pc2


def _batch():
    pc1, pc2 = _pair()
    n = pc1.shape[0]
    return dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))


def _jax_spec():
    return JaxSpec(d=3, scales=tuple(
        JaxScale(s, b, f, c, capacity=cap)
        for (s, b, f, c), cap in zip(SFM5, CAPS)))


def _tree():
    return seeded_jax_params(HPLFlowNetShallow(SFM5, device="cpu"), REF_SEED)


def _port_model():
    return params_from_jax(_tree(), HPLFlowNetShallow(SFM5, device="cpu"))


@functools.lru_cache(maxsize=None)
def _jax_flow():
    pc1, pc2 = _pair()
    tree = jax.tree_util.tree_map(jnp.asarray, _tree())
    with exact_mode():
        fwd = jax.jit(lambda p, a, b: jax_flow_forward(
            JaxShallow(scales_filter_map=SFM5), p, _jax_spec(), a, b,
            adjoint_plans=False))
        return np.asarray(fwd(tree, jnp.asarray(pc1), jnp.asarray(pc2)))


@functools.lru_cache(maxsize=None)
def _jax_grads(exact_sums: bool):
    """(loss, {state_dict name: gradient}) of JAX's step, exact mode."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    tree = jax.tree_util.tree_map(jnp.asarray, _tree())
    model = JaxShallow(scales_filter_map=SFM5)
    patch = (mock.patch.object(jseg, "_wr_forward", _exact_wr_forward)
             if exact_sums else contextlib.nullcontext())
    with exact_mode(), patch:
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p, b: jax_batched_loss(model, _jax_spec(), p, b)[0]))(tree, batch)
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in flat.items()}


@functools.lru_cache(maxsize=None)
def _port_grads():
    model = _port_model()
    loss, overflow, grads = tstep.loss_and_grad(
        model, make_lattice_spec(SFM5, CAPS), dict(model.named_parameters()),
        _batch())
    assert int(overflow) == 0
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _port_flow():
    pc1, pc2 = _pair()
    return flow_forward(_port_model(), make_lattice_spec(SFM5, CAPS), pc1, pc2,
                        adjoint_plans=False).numpy()


def _assert_close(got, want):
    assert got.shape == want.shape == (64, 3)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max()
    assert err <= ATOL, err
    assert err / np.abs(want).max() <= MAX_REL


def test_forward_matches_jax():
    _assert_close(_port_flow(), _jax_flow())


def test_forward_matches_the_numpy_oracle():
    """tests/test_e2e_parity.py's oracle composition on JAX's pyramid (the
    port's tables equal it, tests/test_torch_lattice.py), same gate."""
    pc1, pc2 = _pair()
    scales = jax_build_pyramid(_jax_spec(), jnp.asarray(pc1), jnp.asarray(pc2))
    want = shallow_oracle_forward(_tree()["params"], scales, pc1, pc2)
    got = _port_flow()
    assert got.shape == want.shape == (64, 3)
    np.testing.assert_allclose(got, want, atol=5e-3)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-2


@pytest.mark.parametrize("exact_sums", [False, True])
def test_loss_and_every_gradient_match_jax(exact_sums):
    want_loss, want = _jax_grads(exact_sums)
    got_loss, got = _port_grads()
    errs = _leaf_errors(got, want)
    assert len(errs) == len(list(HPLFlowNetShallow(SFM5, device="cpu").parameters()))
    if exact_sums:
        assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
        assert max(errs.values()) <= EXACT_TOL, max(errs.items(), key=lambda kv: kv[1])
    else:
        assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
        assert max(errs.values()) <= LIVE_TOL, max(errs.items(), key=lambda kv: kv[1])
        assert np.median(list(errs.values())) <= LIVE_MEDIAN_TOL


def shallow_reference_case():
    """The case frozen for the card: inputs, JAX's flow and loss, and per
    leaf the gradient's norm and seeded dot products, from JAX as it is and
    with exact segment sums (``chip_smoke.grad_summary``)."""
    case = {k: v for k, v in _batch().items() if k in ("pc1", "pc2", "sf")}
    case.update(capacities=np.asarray(CAPS, np.int32), seed=np.asarray(REF_SEED),
                flow=_jax_flow())
    names = [k for k, _ in HPLFlowNetShallow(SFM5, device="cpu").named_parameters()]
    case["names"] = np.asarray(names)
    for prefix, exact in (("", False), ("exact_", True)):
        loss, grads = _jax_grads(exact)
        norms, dots = chip_smoke.grad_summary(grads, names)
        case.update({f"{prefix}loss": np.asarray(loss),
                     f"{prefix}grad_norm": norms, f"{prefix}grad_dots": dots})
    return case


def test_frozen_reference_is_current_and_port_matches_it():
    case = shallow_reference_case()
    ref = np.load(REF_NPZ)
    assert set(ref.files) == set(case)
    for k in ("pc1", "pc2", "sf", "capacities", "seed", "names"):
        np.testing.assert_array_equal(ref[k], case[k])
    np.testing.assert_allclose(ref["flow"], case["flow"], rtol=0, atol=1e-6)
    for k in case:
        if k.endswith(("loss", "grad_norm", "grad_dots")):
            np.testing.assert_allclose(ref[k], case[k], rtol=1e-5, atol=1e-9)
    _assert_close(_port_flow(), ref["flow"])
    loss, grads = _port_grads()
    rows = chip_smoke.check_train_reference(
        ref, loss, {k: torch.from_numpy(v) for k, v in grads.items()})
    assert [r["against"] for r in rows] == ["jax", "exact"]


def test_seeded_params_have_the_jax_tree_structure():
    pc1, pc2 = _pair()

    def init(a, b):
        return JaxShallow(scales_filter_map=SFM5).init(
            jax.random.PRNGKey(0), a, b, jax_build_pyramid(_jax_spec(), a, b))
    shapes = jax.eval_shape(init, jnp.asarray(pc1), jnp.asarray(pc2))
    want = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    got = {jax.tree_util.keystr(k): v.shape
           for k, v in jax.tree_util.tree_flatten_with_path(_tree())[0]}
    assert got == want


def test_registry_and_scale_counts():
    assert MODELS == {"HPLFlowNet": HPLFlowNet, "HPLFlowNetShallow": HPLFlowNetShallow}
    model = get_model("HPLFlowNetShallow", scales_filter_map=SFM5, device="cpu")
    assert isinstance(model, HPLFlowNetShallow)
    with pytest.raises(KeyError, match="available"):
        get_model("NoSuchNet", scales_filter_map=SFM5, device="cpu")
    with pytest.raises(AssertionError, match="5 scales"):
        HPLFlowNetShallow(SFM5[:4], device="cpu")


if __name__ == "__main__":
    np.savez(REF_NPZ, **shallow_reference_case())
    print(f"wrote {REF_NPZ}")
