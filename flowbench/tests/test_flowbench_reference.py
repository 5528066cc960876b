"""The frozen reference agrees with the measured program at a small size.

On the CPU the program runs its plain versions; at float32 the two must
agree to rounding, and every lattice table of both models bit for bit.
"""

import numpy as np
import pytest
import torch

from flowbench.configs import load_config
from flowbench.reference import lattice as ref_lattice
from flowbench.reference import model as ref_model
from flowbench.reference import train as ref_train
from flowbench.traffic.generator import load_mix, make_pool

POINTS = "128"


def _case(name, seed=3):
    cfg = load_config(name)
    mix = dict(load_mix("eval-8k"), num_points=int(POINTS), pool=2)
    return cfg, cfg["capacities"][POINTS], make_pool(mix, seed)


def _program(cfg, params, dtype="float32"):
    from hplflownet_tpu_torch.models import MODELS
    model = MODELS[cfg["arch"]](cfg["scales_filter_map"], compute_dtype=dtype,
                                device="cpu")
    model.load_state_dict(params, strict=True)
    return model


@pytest.mark.parametrize("name", ["flagship", "shallow"])
def test_parameters_match_the_program(name):
    cfg = load_config(name)
    shapes = ref_model.param_shapes(cfg)
    from hplflownet_tpu_torch.models import MODELS
    model = MODELS[cfg["arch"]](cfg["scales_filter_map"], device="cpu")
    own = {k: tuple(v.shape) for k, v in model.named_parameters()}
    assert own == {k: tuple(v) for k, v in shapes.items()}
    assert sum(int(np.prod(s)) for s in shapes.values()) == cfg["num_parameters"]


def test_weights_follow_the_seed():
    cfg = load_config("shallow")
    a = ref_model.init_params(cfg, 2**33 + 5, "cpu")
    b = ref_model.init_params(cfg, 2**33 + 5, "cpu")
    c = ref_model.init_params(cfg, 2**33 + 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["conv1.dense0_kernel"], c["conv1.dense0_kernel"])


@pytest.mark.parametrize("name", ["flagship", "shallow"])
def test_tables_match_the_program(name):
    from hplflownet_tpu_torch.lattice.build import build_pyramid
    from hplflownet_tpu_torch.pipeline import make_lattice_spec
    cfg, caps, pool = _case(name)
    a, b = torch.from_numpy(pool.pc1[0]), torch.from_numpy(pool.pc2[0])
    got = build_pyramid(make_lattice_spec(cfg["scales_filter_map"], caps), a, b,
                        adjoint_plans=False)
    want = ref_lattice.build_pyramid(cfg["scales_filter_map"], caps, a, b)
    for p, r in zip(got, want):
        for c, cl in ((1, r.cloud1), (2, r.cloud2)):
            assert torch.equal(getattr(p, f"pc{c}_lattice_offset").long(), cl.offsets)
            assert torch.equal(getattr(p, f"pc{c}_barycentric"), cl.barycentric)
            assert torch.equal(getattr(p, f"pc{c}_el_minus_gr"), cl.el_minus_gr)
            assert int(getattr(p, f"pc{c}_num_valid")) == cl.num_valid
            assert int(getattr(p, f"pc{c}_overflow")) == cl.overflow
        assert torch.equal(p.pc1_blur_neighbors.long(), r.blur1)
        assert torch.equal(p.pc2_blur_neighbors.long(), r.blur2)
        if r.corr1 is not None:
            assert torch.equal(p.pc1_corr_indices.long(), r.corr1)
            assert torch.equal(p.pc2_corr_uniq.long()[p.pc2_corr_inverse.long()],
                               r.cross)


@pytest.mark.parametrize("name", ["flagship", "shallow"])
def test_forward_matches_the_program(name):
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    cfg, caps, pool = _case(name)
    params = ref_model.init_params(cfg, 11, "cpu")
    spec = make_lattice_spec(cfg["scales_filter_map"], caps)
    got = flow_forward(_program(cfg, params), spec, pool.pc1[0], pool.pc2[0],
                       adjoint_plans=False)
    a, b = torch.from_numpy(pool.pc1[0]), torch.from_numpy(pool.pc2[0])
    with torch.no_grad():
        want = ref_model.forward(cfg, params, a, b,
                                 ref_lattice.build_pyramid(cfg["scales_filter_map"],
                                                           caps, a, b))
    assert float((got - want).norm() / want.norm()) < 1e-5


def test_train_steps_match_the_program():
    from hplflownet_tpu_torch.pipeline import make_lattice_spec
    from hplflownet_tpu_torch.train.step import make_train_step
    from flowbench.entries.train import compare
    cfg, caps, pool = _case("shallow")
    params = ref_model.init_params(cfg, 12, "cpu")
    model = _program(cfg, params)
    init, step = make_train_step(model, make_lattice_spec(cfg["scales_filter_map"], caps),
                                 learning_rate=cfg["learning_rate"],
                                 on_overflow="skip", device="cpu")
    state, losses, grad_norms = init(), [], None
    ones = np.ones((1, int(POINTS)), dtype=bool)
    for k in range(2):
        state, loss, _ = step.with_overflow(state, {
            "pc1": pool.pc1[k][None], "pc2": pool.pc2[k][None],
            "sf": pool.sf[k][None], "valid1": ones, "valid2": ones})
        losses.append(float(loss))
        if k == 0:
            grad_norms = {n: float(m.double().norm() / (1 - ref_train.B1))
                          for n, m in state.opt_state.mu.items()}
    batches = [{"pc1": torch.from_numpy(pool.pc1[k]), "pc2": torch.from_numpy(pool.pc2[k]),
                "sf": torch.from_numpy(pool.sf[k])} for k in range(2)]
    ref = ref_train.train_steps(cfg, params, batches, caps)
    gaps = compare(params, losses, grad_norms, state.params, *ref)
    assert gaps["loss_gap"]["value"] < 1e-5
    assert gaps["grad_gap"]["value"] < 1e-4
    assert gaps["update_gap"]["value"] < 1e-3
