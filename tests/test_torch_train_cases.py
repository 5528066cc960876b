"""The port against the JAX package on cases the flagship tests leave out.

* EPE3D at zero error: JAX's ``jnp.linalg.norm`` has a NaN gradient where
  pred == target exactly, even on an invalid point (the mask multiplies
  after the norm); the port's ``torch.linalg.vector_norm`` gives 0 there,
  and keeps it (a NaN would poison Adam).  Every other point agrees.
* Batch 2 with invalid points: the float32 n = 64 loss and gradients of a
  two-sample batch with some ``valid1``/``valid2`` False.  The port loops
  over the samples, JAX maps over them; the loss is one mean over the valid
  points of the whole batch in both.
* The model flags off their defaults (``use_leaky=False``,
  ``bcn_use_norm=False``, ``bcn_use_bias=False``, ``last_relu=True``), one
  at a time: the float32 n = 64 forward and train-step gradients.

With ``use_leaky=False`` one ReLU input of ``corr2``'s first correlation
conv is 1.9e-9, below what the float32 sums of its ~1e-1 terms resolve:
JAX's order and the port's put it on opposite sides of 0, so the gate, and
the gradient through that one element, differ (7.5e-4 of
``corr2.corr0_bias``'s norm against JAX with exact segment sums).  That
case is held to JAX as it is, and then, with the one pre-activation under
1e-8 in magnitude negated, to JAX with exact sums at the same tolerance as
every other case (reached 1.2e-6).

The JAX side (exact mode, seeded weights) is frozen in
tests/data/torch_port_cases_n64.npz: the flow, and the loss with per-leaf
gradient norms and seeded dot products (``chip_smoke.grad_summary``), from
JAX as it is and from JAX with exact segment sums.  The port is held to
them at ``chip_smoke.TRAIN_TOL`` and, for the flow, at the forward test's
ATOL / MAX_REL.  Rewrite the file with ``python -m
tests.test_torch_train_cases`` (a few minutes: ten JAX gradient compiles).
"""

import contextlib
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hplflownet_tpu.models.losses import epe3d_loss as jax_epe3d_loss
from hplflownet_tpu_torch.models import HPLFlowNet
from hplflownet_tpu_torch.models.losses import epe3d_loss
from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
from hplflownet_tpu_torch.train import step as tstep

try:
    from test_torch_model import ATOL, CAPS, MAX_REL, SFM7, _pair
except ImportError:          # run as ``python -m tests.test_torch_train_cases``
    from tests.test_torch_model import ATOL, CAPS, MAX_REL, SFM7, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(ROOT, "tests", "data", "torch_port_cases_n64.npz")
REF_SEED = 0
FLAG_CASES = {"no_leaky": dict(use_leaky=False),
              "no_norm": dict(bcn_use_norm=False),
              "no_bias": dict(bcn_use_bias=False),
              "last_relu": dict(last_relu=True)}


def test_epe3d_gradient_at_zero_error_is_zero_where_jax_gives_nan():
    rng = np.random.RandomState(0)
    pred = rng.randn(2, 6, 3).astype(np.float32)
    target = pred + rng.randn(2, 6, 3).astype(np.float32)
    target[0, 1] = pred[0, 1]                 # zero error, valid point
    target[1, 4] = pred[1, 4]                 # zero error, invalid point
    valid = np.ones((2, 6), bool)
    valid[1, 4] = valid[0, 5] = False
    zero = np.zeros((2, 6), bool)
    zero[0, 1] = zero[1, 4] = True

    loss_j, grad_j = jax.value_and_grad(jax_epe3d_loss)(
        jnp.asarray(pred), jnp.asarray(target), jnp.asarray(valid))
    grad_j = np.asarray(grad_j)
    p = torch.from_numpy(pred).requires_grad_(True)
    loss_t = epe3d_loss(p, torch.from_numpy(target), torch.from_numpy(valid))
    loss_t.backward()
    grad_t = p.grad.numpy()

    # the divergence: NaN in JAX, 0 in the port, on both zero-error points
    assert np.isnan(grad_j[zero]).all()
    assert (grad_t[zero] == 0).all()
    # everywhere else the two agree, the loss too
    np.testing.assert_allclose(grad_t[~zero], grad_j[~zero], rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=1e-6)
    assert (grad_t[1, 4] == 0).all() and (grad_t[0, 5] == 0).all()


def _batch2():
    """Two 64-point samples; some points of each cloud invalid."""
    pc1a, pc2a = _pair()
    rng = np.random.RandomState(12)
    pc1b = (rng.randn(64, 3) * 2.0).astype(np.float32)
    pc2b = pc1b + 0.05 * rng.randn(64, 3).astype(np.float32)
    pc1, pc2 = np.stack([pc1a, pc1b]), np.stack([pc2a, pc2b])
    valid1 = rng.rand(2, 64) > 0.15
    valid2 = rng.rand(2, 64) > 0.15
    return dict(pc1=pc1, pc2=pc2, sf=pc2 - pc1, valid1=valid1, valid2=valid2)


def _batch1():
    pc1, pc2 = _pair()
    n = pc1.shape[0]
    return dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))


def _port_model(flags):
    model = HPLFlowNet(SFM7, device="cpu", **flags)
    return params_from_jax(seeded_jax_params(model, REF_SEED), model)


def _case_ref(ref, case):
    """The frozen entries of one case, under check_train_reference's keys."""
    pre = f"{case}__"
    out = {k[len(pre):]: ref[k] for k in ref.files if k.startswith(pre)}
    out["names"] = ref[f"{case}__names"]
    return out


TIE = 1e-8      # a ReLU input this close to 0 has no float32-resolved sign


def _check_step(ref, case, flags, batch, prefixes=("", "exact_")):
    model = _port_model(flags)
    loss, overflow, grads = tstep.loss_and_grad(
        model, make_lattice_spec(SFM7, CAPS), dict(model.named_parameters()),
        batch)
    assert int(overflow) == 0
    rows = chip_smoke.check_train_reference(_case_ref(ref, case), float(loss),
                                            grads, prefixes)
    assert [r["against"] for r in rows] == [
        {"": "jax", "exact_": "exact"}[p] for p in prefixes]
    return model


def test_relu_tie_is_the_only_departure_from_exact_jax(monkeypatch):
    """``use_leaky=False``: the one correlation ReLU input under TIE, negated
    to the side JAX's sums put it, leaves the port within the exact-sum
    tolerance of JAX; nothing else departs."""
    from hplflownet_tpu_torch.ops import corr
    ties = []
    act = corr.activation

    def gate_flipped(x, use_leaky):
        tie = x.abs() < TIE
        ties.append(int(tie.sum()))
        return act(torch.where(tie, -x, x), use_leaky)

    monkeypatch.setattr(corr, "activation", gate_flipped)
    _check_step(np.load(REF_NPZ), "no_leaky", FLAG_CASES["no_leaky"], _batch1())
    assert sum(ties) == 1, ties


def test_batch2_with_invalid_points_matches_frozen_jax():
    ref = np.load(REF_NPZ)
    batch = _batch2()
    for k in ("pc1", "pc2", "sf", "valid1", "valid2"):
        np.testing.assert_array_equal(ref[f"batch2__{k}"], batch[k])
    assert not batch["valid1"].all() and not batch["valid2"].all()
    _check_step(ref, "batch2", {}, batch)


@pytest.mark.parametrize("case", sorted(FLAG_CASES))
def test_model_flag_forward_and_gradients_match_frozen_jax(case):
    ref = np.load(REF_NPZ)
    batch = _batch1()
    np.testing.assert_array_equal(ref[f"{case}__pc1"], batch["pc1"])
    # no_leaky against exact sums: test_relu_tie_is_the_only_departure_...
    prefixes = ("",) if case == "no_leaky" else ("", "exact_")
    model = _check_step(ref, case, FLAG_CASES[case], batch, prefixes)
    flow = flow_forward(model, make_lattice_spec(SFM7, CAPS), batch["pc1"][0],
                        batch["pc2"][0], adjoint_plans=False).numpy()
    want = ref[f"{case}__flow"]
    assert flow.shape == want.shape == (64, 3) and np.isfinite(flow).all()
    err = np.abs(flow - want).max()
    assert err <= ATOL and err / np.abs(want).max() <= MAX_REL, err


# ---------------------------------------------------------------------------
# the frozen JAX side
# ---------------------------------------------------------------------------

def _jax_case(flags, batch):
    """JAX's flow (sample 0) and step summary on ``batch``, exact mode."""
    from hplflownet_tpu.lattice import LatticeSpec as JaxSpec, ScaleSpec as JaxScale
    from hplflownet_tpu.models import HPLFlowNet as JaxHPLFlowNet
    from hplflownet_tpu.ops import segment as jseg
    from hplflownet_tpu.ops.dispatch import exact_mode
    from hplflownet_tpu.pipeline import flow_forward as jax_flow_forward
    from hplflownet_tpu.train.step import _batched_loss as jax_batched_loss
    try:
        from test_torch_train import _exact_wr_forward
    except ImportError:
        from tests.test_torch_train import _exact_wr_forward

    spec = JaxSpec(d=3, scales=tuple(
        JaxScale(s, b, f, c, capacity=cap)
        for (s, b, f, c), cap in zip(SFM7, CAPS)))
    model = JaxHPLFlowNet(scales_filter_map=SFM7, **flags)
    port_model = HPLFlowNet(SFM7, device="cpu", **flags)
    names = [k for k, _ in port_model.named_parameters()]
    tree = jax.tree_util.tree_map(jnp.asarray,
                                  seeded_jax_params(port_model, REF_SEED))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out = {"names": np.asarray(names)}
    for prefix, exact in (("", False), ("exact_", True)):
        patch = (mock.patch.object(jseg, "_wr_forward", _exact_wr_forward)
                 if exact else contextlib.nullcontext())
        with exact_mode(), patch:
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p, b: jax_batched_loss(model, spec, p, b)[0]))(tree, jbatch)
        flat = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
        norms, dots = chip_smoke.grad_summary(
            {k: v.numpy() for k, v in flat.items()}, names)
        out.update({f"{prefix}loss": np.asarray(float(loss)),
                    f"{prefix}grad_norm": norms, f"{prefix}grad_dots": dots})
    with exact_mode():
        out["flow"] = np.asarray(jax.jit(lambda p, a, b: jax_flow_forward(
            model, p, spec, a, b, adjoint_plans=False))(
            tree, jbatch["pc1"][0], jbatch["pc2"][0]))
    return out


def cases_reference():
    ref = {}
    for case, flags, batch in ([("batch2", {}, _batch2())]
                               + [(c, f, _batch1())
                                  for c, f in sorted(FLAG_CASES.items())]):
        entries = _jax_case(flags, batch)
        if case == "batch2":
            entries.update(batch)
            entries.pop("flow")
        else:
            entries["pc1"] = batch["pc1"]
        ref.update({f"{case}__{k}": v for k, v in entries.items()})
        print(case, float(entries["loss"]), float(entries["exact_loss"]),
              flush=True)
    return ref


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(REF_NPZ, **cases_reference())
    print(f"wrote {REF_NPZ}")
