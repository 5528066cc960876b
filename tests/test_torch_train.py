"""The port's training slice against the JAX package, on the CPU.

The whole 7-scale step at n = 64 in float32: the port's loss and every
gradient leaf (``train.step.loss_and_grad``) against ``jax.value_and_grad``
of the JAX package's ``_batched_loss`` in ``exact_mode()``, on the trained
``full7_params_d.pkl`` and on the seeded weights.  Then one Adam step from
identical gradients and state against optax, the overflow skip, an audit of
the autograd graph (no scatter anywhere), the init schemes, the schedule
and the entry points' device rule.

Tolerances of the whole-slice gradient, per leaf, as max|port - JAX| over
max|JAX|:

* against JAX as it is: 5e-2.  JAX's float32 segment sums take each run's
  share beyond its first 128-entry block as a prefix difference
  (``hplflownet_tpu/ops/segment.py`` ``_combine``), about 3e-7 absolute per
  run, and the splat's ``1 / (density + 1e-5)`` multiplies that by up to
  1e5 on vertices whose density is below 1e-5 (a vertex touched only by a
  near-zero barycentric weight).  The port sums each run on its own.
  Reached: 2.8e-2 on the seeded weights (median leaf 2.0e-3), 3.8e-3 on
  the trained ones (median 5.6e-5);
* against JAX with exact segment sums (its ``_wr_forward`` swapped for a
  scatter-add per run, its own custom VJPs untouched): 1e-4.

The seeded case is frozen, as gradient norms and dot products with seeded
directions, in tests/data/torch_port_train_ref_n64.npz, which
``chip_smoke.py`` holds the card's kernel path against; a test here
regenerates it.  Run ``python -m tests.test_torch_train`` to rewrite it.
"""

import contextlib
import functools
import os
import pickle
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import chip_smoke
from hplflownet_tpu.lattice import LatticeSpec as JaxSpec, ScaleSpec as JaxScale
from hplflownet_tpu.models import HPLFlowNet as JaxHPLFlowNet
from hplflownet_tpu.ops import segment as jseg
from hplflownet_tpu.ops.dispatch import exact_mode
from hplflownet_tpu.train.schedule import lr_at_epoch as jax_lr_at_epoch
from hplflownet_tpu.train.step import _batched_loss as jax_batched_loss
from hplflownet_tpu_torch.models import HPLFlowNet
from hplflownet_tpu_torch.models.init import _fans, reinit_params
from hplflownet_tpu_torch.params import (opt_state_from_jax, params_from_jax,
                                         seeded_jax_params)
from hplflownet_tpu_torch.pipeline import make_lattice_spec
from hplflownet_tpu_torch.train import step as tstep
from hplflownet_tpu_torch.train.schedule import lr_at_epoch

try:
    from test_torch_model import CAPS, PICKLE, SFM7, _pair
except ImportError:          # run as ``python -m tests.test_torch_train``
    from tests.test_torch_model import CAPS, PICKLE, SFM7, _pair

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_NPZ = os.path.join(ROOT, chip_smoke.TRAIN_REF_NPZ)
REF_SEED = 0
LIVE_TOL, LIVE_MEDIAN_TOL, EXACT_TOL = 5e-2, 5e-3, 1e-4


def _batch():
    pc1, pc2 = _pair()
    n = pc1.shape[0]
    return dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))


def _tree(weights):
    if weights == "trained":
        with open(PICKLE, "rb") as fd:
            return pickle.load(fd)
    return seeded_jax_params(HPLFlowNet(SFM7, device="cpu"), REF_SEED)


def _exact_wr_forward(with_weights, plan, rows, weights):
    """JAX ``weighted_reduce``'s forward with each run summed on its own:
    one float32 scatter-add per barycentric lane (products still rounded in
    the stream dtype, as JAX's)."""
    n, c = rows.shape
    r = weights.shape[1]
    t = plan.start.shape[0]
    ids = plan.ids.reshape(n, r)
    out = jnp.zeros((t + 1, c + int(with_weights)), jnp.float32)
    for k in range(r):
        w = weights[:, k, None].astype(rows.dtype)
        v = (rows * w).astype(jnp.float32)
        if with_weights:
            v = jnp.concatenate([v, w.astype(jnp.float32)], axis=1)
        out = out.at[jnp.where(ids[:, k] >= 0, ids[:, k], t)].add(v)
    return out[:t]


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(exact_sums):
    """One jitted function per variant: each traces with its own reduction."""
    spec = JaxSpec(d=3, scales=tuple(
        JaxScale(s, b, f, c, capacity=cap)
        for (s, b, f, c), cap in zip(SFM7, CAPS)))
    model = JaxHPLFlowNet(scales_filter_map=SFM7)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jax_batched_loss(model, spec, p, b)[0]))


@functools.lru_cache(maxsize=None)
def _jax_grads(weights, exact_sums=False):
    """(loss, {state_dict name: gradient}) of JAX's step, exact mode."""
    batch = {k: jnp.asarray(v) for k, v in _batch().items()}
    tree = jax.tree_util.tree_map(jnp.asarray, _tree(weights))
    patch = (mock.patch.object(jseg, "_wr_forward", _exact_wr_forward)
             if exact_sums else contextlib.nullcontext())
    with exact_mode(), patch:
        loss, grads = _jax_value_and_grad(exact_sums)(tree, batch)
    flat = params_from_jax(jax.tree_util.tree_map(np.asarray, grads))
    return float(loss), {k: v.numpy() for k, v in flat.items()}


def _port_model(tree):
    return params_from_jax(tree, HPLFlowNet(SFM7, device="cpu"))


@functools.lru_cache(maxsize=None)
def _port_grads(weights):
    model = _port_model(_tree(weights))
    loss, overflow, grads = tstep.loss_and_grad(
        model, make_lattice_spec(SFM7, CAPS), dict(model.named_parameters()),
        _batch())
    assert int(overflow) == 0
    return float(loss), {k: g.numpy() for k, g in grads.items()}


def _leaf_errors(got, want):
    assert set(got) == set(want)
    return {k: float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            for k in want}


@pytest.mark.parametrize("weights", ["trained", "seeded"])
def test_whole_slice_loss_and_every_gradient_match_jax(weights):
    want_loss, want = _jax_grads(weights)
    got_loss, got = _port_grads(weights)
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    errs = _leaf_errors(got, want)
    assert len(errs) == 115
    assert max(errs.values()) <= LIVE_TOL, max(errs.items(), key=lambda kv: kv[1])
    assert np.median(list(errs.values())) <= LIVE_MEDIAN_TOL


@pytest.mark.parametrize("weights", ["trained", "seeded"])
def test_whole_slice_gradients_match_jax_with_exact_segment_sums(weights):
    want_loss, want = _jax_grads(weights, exact_sums=True)
    got_loss, got = _port_grads(weights)
    assert abs(got_loss - want_loss) <= 1e-6 * abs(want_loss)
    errs = _leaf_errors(got, want)
    assert max(errs.values()) <= EXACT_TOL, max(errs.items(), key=lambda kv: kv[1])


def train_reference_case():
    """The seeded case frozen for the card: inputs, JAX's loss, and per
    leaf the gradient's norm and dot products with seeded directions, from
    JAX as it is and from JAX with exact segment sums."""
    case = {k: v for k, v in _batch().items() if k in ("pc1", "pc2", "sf")}
    case.update(capacities=np.asarray(CAPS, np.int32), seed=np.asarray(REF_SEED))
    names = [k for k, _ in HPLFlowNet(SFM7, device="cpu").named_parameters()]
    case["names"] = np.asarray(names)
    for prefix, exact in (("", False), ("exact_", True)):
        loss, grads = _jax_grads("seeded", exact)
        norms, dots = chip_smoke.grad_summary(grads, names)
        case.update({f"{prefix}loss": np.asarray(loss),
                     f"{prefix}grad_norm": norms, f"{prefix}grad_dots": dots})
    return case


def test_frozen_train_reference_is_current_and_port_matches_it():
    case = train_reference_case()
    ref = np.load(REF_NPZ)
    assert set(ref.files) == set(case)
    for k in ("pc1", "pc2", "sf", "capacities", "seed", "names"):
        np.testing.assert_array_equal(ref[k], case[k])
    for k in case:
        if k.endswith(("loss", "grad_norm", "grad_dots")):
            np.testing.assert_allclose(ref[k], case[k], rtol=1e-5, atol=1e-9)
    loss, grads = _port_grads("seeded")
    rows = chip_smoke.check_train_reference(
        ref, loss, {k: torch.from_numpy(v) for k, v in grads.items()})
    assert [r["against"] for r in rows] == ["jax", "exact"]


def test_one_adam_step_matches_optax_from_identical_state():
    rng = np.random.RandomState(0)
    shapes = {"bcn1": {"conv0_kernel": (15, 8, 6), "conv0_bias": (6,)},
              "conv4": {"dense0_kernel": (7, 3), "dense0_bias": (3,)}}

    def tree(scale):
        return {"params": {m: {n: (rng.randn(*s) * scale).astype(np.float32)
                               for n, s in leaves.items()}
                           for m, leaves in shapes.items()}}

    params, g1, g2 = tree(1.0), tree(1e-3), tree(1e-3)
    tx = optax.inject_hyperparams(optax.adam)(learning_rate=3e-4)
    st = tx.init(params)
    u, st = tx.update(g1, st, params)
    params1 = optax.apply_updates(params, u)
    u, st2 = tx.update(g2, st, params1)
    want = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                  optax.apply_updates(params1, u)))

    opt = opt_state_from_jax(jax.device_get(st), device="cpu")
    assert int(opt.count) == 1 and float(opt.learning_rate) == np.float32(3e-4)
    got, opt2 = tstep.adam_update(
        params_from_jax(g2), opt,
        params_from_jax(jax.tree_util.tree_map(np.asarray, params1)))
    assert int(opt2.count) == 2
    moments = opt_state_from_jax(jax.device_get(st2), device="cpu")
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6)
        np.testing.assert_allclose(opt2.mu[k].numpy(), moments.mu[k].numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(opt2.nu[k].numpy(), moments.nu[k].numpy(),
                                   rtol=1e-6)


def _cpu_step(capacities, on_overflow, lr=1e-3):
    model = _port_model(_tree("seeded"))
    return tstep.make_train_step(model, make_lattice_spec(SFM7, capacities),
                                 learning_rate=lr, on_overflow=on_overflow,
                                 device="cpu")


def test_overflow_skip_leaves_params_moments_and_step_untouched():
    """tests/test_train.py:84 for the port: capacities far below a 64-point
    cloud's vertex count overflow; "skip" keeps the old state, "keep"
    applies the update."""
    init, step = _cpu_step([32] * 7, "skip")
    state = init()
    new, loss, overflow = step.with_overflow(state, _batch())
    assert int(overflow) > 0 and np.isfinite(float(loss))
    for k in state.params:
        assert torch.equal(new.params[k], state.params[k])
        assert torch.equal(new.opt_state.mu[k], state.opt_state.mu[k])
        assert torch.equal(new.opt_state.nu[k], state.opt_state.nu[k])
    assert int(new.step) == 0 and int(new.opt_state.count) == 0

    init, step = _cpu_step([32] * 7, "keep")
    state = init()
    new, _, overflow = step.with_overflow(state, _batch())
    assert int(overflow) > 0
    assert any(not torch.equal(new.params[k], state.params[k]) for k in state.params)
    assert int(new.step) == 1 and int(new.opt_state.count) == 1


def test_clean_step_updates_by_at_most_the_learning_rate():
    """No overflow: "skip" applies the update.  Adam's first step moves
    each parameter by lr * |g| / (|g| + eps) <= lr, and the learning rate
    set between steps is the one used."""
    init, step = _cpu_step(CAPS, "skip")
    state = tstep.set_learning_rate(init(), 3e-5)
    assert float(state.opt_state.learning_rate) == np.float32(3e-5)
    new, loss = step(state, _batch())
    assert int(new.step) == 1 and np.isfinite(float(loss))
    moved = max(float((new.params[k] - state.params[k]).abs().max())
                for k in state.params)
    assert 0 < moved <= 3e-5 * (1 + 1e-3)
    # the eval step's loss is the train step's forward
    ev_loss, pred = tstep.make_eval_step(_port_model(_tree("seeded")),
                                         make_lattice_spec(SFM7, CAPS))(None, _batch())
    assert pred.shape == (1, 64, 3)
    assert abs(float(ev_loss) - float(loss)) <= 1e-6 * float(loss)


FORBIDDEN = ("IndexBackward", "IndexPutBackward", "ScatterAddBackward",
             "ScatterBackward", "GatherBackward", "IndexAddBackward",
             "IndexSelectBackward")


def test_autograd_graph_has_no_index_or_scatter_node():
    """Every gather of a differentiable tensor sits inside a Function with a
    deterministic backward: the graph has no node whose backward would be an
    index_put / scatter_add (float atomics on the card)."""
    model = _port_model(_tree("seeded"))
    batch = tstep._batch_to(_batch(), "cpu")
    loss, _, _ = tstep._batched_loss(model, make_lattice_spec(SFM7, CAPS),
                                     dict(model.named_parameters()), batch)
    seen, stack, names = set(), [loss.grad_fn], set()
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.add(type(fn).__name__)
        stack.extend(nxt for nxt, _ in fn.next_functions)
    assert not [n for n in names if n.startswith(FORBIDDEN)], sorted(names)
    assert {"_BlurBackward", "_SliceBackward", "_WeightedReduceBackward",
            "_CorrSelfBackward", "_CorrCrossBackward"} <= names


def _init_params():
    """tests/test_init.py's tree, under the port's names."""
    rng = np.random.RandomState(0)
    shapes = {"conv1.dense0_kernel": (64, 128), "conv1.dense0_bias": (128,),
              "bcn1.conv0_kernel": (15, 68, 64), "bcn1.conv0_bias": (64,),
              "bcn1.slice_bias": (64,)}
    return {k: torch.from_numpy(rng.randn(*s).astype(np.float32))
            for k, s in shapes.items()}


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_reinit_schemes_zero_biases_and_draw_their_statistics():
    """tests/test_init.py's checks for the port (same distributions; the
    draws are not JAX's)."""
    for scheme in ("normal", "xavier", "kaiming", "orthogonal"):
        out = reinit_params(_gen(1), _init_params(), scheme)
        for name, v in out.items():
            assert v.shape == _init_params()[name].shape
            if name.endswith("bias"):
                assert torch.count_nonzero(v) == 0
            else:
                assert v.abs().sum() > 0
    k = reinit_params(_gen(2), _init_params(), "normal", gain=0.02)[
        "conv1.dense0_kernel"]
    assert abs(float(k.std()) - 0.02) < 0.003
    fan_in, fan_out = _fans((15, 68, 64))
    assert (fan_in, fan_out) == (68 * 15, 64 * 15)
    x1 = reinit_params(_gen(3), _init_params(), "xavier")["bcn1.conv0_kernel"]
    x2 = reinit_params(_gen(3), _init_params(), "xavier", gain=2.0)["bcn1.conv0_kernel"]
    expected = np.sqrt(2.0 / (fan_in + fan_out))
    assert abs(float(x1.std()) - expected) / expected < 0.1
    torch.testing.assert_close(x2, 2.0 * x1)
    k = reinit_params(_gen(4), _init_params(), "kaiming")["conv1.dense0_kernel"]
    assert abs(float(k.std()) - np.sqrt(2.0 / 64)) / np.sqrt(2.0 / 64) < 0.1
    k = reinit_params(_gen(5), _init_params(), "orthogonal", gain=3.0)[
        "bcn1.conv0_kernel"].reshape(-1, 64)
    np.testing.assert_allclose((k.t() @ k).numpy(), 9.0 * np.eye(64), atol=1e-3)
    with pytest.raises(NotImplementedError):
        reinit_params(_gen(0), _init_params(), "lecun")


def test_schedule_is_the_jax_schedule():
    lrs, sw = [1e-4, 7e-5, 4.9e-5], [0, 110, 220]
    for epoch in (0, 109, 110, 219, 220, 500):
        assert (lr_at_epoch(epoch, custom_lr=True, lr=1e-4, lrs=lrs,
                            lr_switch_epochs=sw)
                == jax_lr_at_epoch(epoch, custom_lr=True, lr=1e-4, lrs=lrs,
                                   lr_switch_epochs=sw))
        kw = dict(custom_lr=False, lr=1e-3, lr_decay_rate=0.5,
                  lr_decay_epochs=10, lr_clip=1e-5)
        assert lr_at_epoch(epoch, **kw) == jax_lr_at_epoch(epoch, **kw)


def test_train_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    model = _port_model(_tree("seeded"))
    spec = make_lattice_spec(SFM7, CAPS)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.make_train_step(model, spec)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tstep.create_train_state(model)
    with pytest.raises(ValueError, match="on_overflow"):
        tstep.make_train_step(model, spec, on_overflow="drop", device="cpu")
    state = tstep.create_train_state(model, device="cpu")
    assert state.params["conv4.dense0_kernel"].device.type == "cpu"


if __name__ == "__main__":
    np.savez(REF_NPZ, **train_reference_case())
    print(f"wrote {REF_NPZ}")
