"""The port's train/evaluate driver end to end on the CPU.

The ``fake_data`` FT3D-layout directory of tests/test_driver.py (shallow
model, 128 points, ``platform: cpu``): train one epoch, checkpoint, resume
and evaluate, through ``train.driver.run`` and through ``python -m
hplflownet_tpu_torch.main``; the JAX driver's ``reset_lr`` semantics and
overwrite guard; checkpoints that restore bit for bit under the JAX
package's naming policy.
"""

import os
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from hplflownet_tpu_torch.train.checkpoint import CheckpointIO
from hplflownet_tpu_torch.train.step import AdamState, TrainState
from hplflownet_tpu_torch.utils.config import Config, parse_args_from_yaml, postprocess
from hplflownet_tpu_torch.train.driver import run

try:
    from test_driver import base_config, make_fake_ft3d
except ImportError:
    from tests.test_driver import base_config, make_fake_ft3d

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
METRICS = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The driver's CPU runs are thousands of small ops: one intra-op thread
    keeps them from spinning against the other test processes' threads
    (under load they ran 3-4x slower with the default count)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fake_data(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_driver")
    make_fake_ft3d(str(root / "data"))
    return root


def _config(fake_data, ckpt_dir, **kw):
    cfg = base_config(fake_data)
    cfg.update(ckpt_dir=str(ckpt_dir), platform="cpu", **kw)
    return cfg


def _run(cfg):
    return run(postprocess(Config(cfg)))


def test_train_then_evaluate_roundtrip(fake_data, tmp_path):
    cfg = _config(fake_data, tmp_path / "ckpt")
    result = _run(cfg)
    assert np.isfinite(result["min_val_epe3d"])
    assert result["train_pairs_per_s"] > 0 and result["seconds_to_first_step"] > 0
    for name in ("checkpoint", "checkpoint_1", "model_best"):
        assert osp.isfile(osp.join(cfg["ckpt_dir"], f"{name}.pt")), name
    log = open(osp.join(cfg["ckpt_dir"], "log")).read()
    assert "Train EPE3D" in log and "Val EPE3D" in log
    assert "torch device: cpu" in log

    # evaluation from the saved checkpoint, with visu dumps, twice: the
    # port sums in a fixed order, so the metrics repeat bit for bit
    ev = dict(cfg, evaluate=True, resume=cfg["ckpt_dir"], dump_visu=True)
    first, second = _run(ev), _run(ev)
    for key in METRICS:
        assert np.isfinite(first[key]), key
        assert first[key] == second[key], key
    assert 0 <= first["acc3ds"] <= 1
    # with 4 val frames in 2 full batches, validation (weighted by real
    # samples) and evaluation (1 per batch) average alike
    assert abs(first["epe3d"] - result["min_val_epe3d"]) <= 1e-6
    visu = [d for d in os.listdir(cfg["ckpt_dir"]) if d.startswith("visu_")]
    dumped = os.listdir(osp.join(cfg["ckpt_dir"], visu[0]))
    assert "output_0.npy" in dumped and "sample_path_list.pickle" in dumped


def test_cli_train_then_evaluate(fake_data, tmp_path):
    """``python -m hplflownet_tpu_torch.main <cfg>`` in a subprocess, from
    the repository root with no PYTHONPATH."""
    cfg = _config(fake_data, tmp_path / "ckpt_cli")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)

    def cli(c, name):
        path = tmp_path / name
        path.write_text(yaml.safe_dump(c))
        return subprocess.run([sys.executable, "-m", "hplflownet_tpu_torch.main",
                               str(path)], capture_output=True, text=True,
                              timeout=600, env=env, cwd=ROOT)

    proc = cli(cfg, "train.yaml")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert osp.isfile(osp.join(cfg["ckpt_dir"], "model_best.pt"))
    proc = cli(dict(cfg, evaluate=True, resume=cfg["ckpt_dir"]), "eval.yaml")
    assert proc.returncode == 0, proc.stderr[-4000:]
    log = (tmp_path / "ckpt_cli" / "log").read_text()
    lines = [ln for ln in log.splitlines() if ln.startswith(" * EPE3D")]
    assert lines, log[-2000:]
    vals = [float(tok) for tok in lines[-1].replace("\t", " ").split()
            if tok.replace(".", "").replace("-", "").isdigit()]
    assert len(vals) == 6 and all(np.isfinite(v) for v in vals), lines[-1]
    usage = subprocess.run([sys.executable, "-m", "hplflownet_tpu_torch.main"],
                           capture_output=True, text=True, timeout=120,
                           env=env, cwd=ROOT)
    assert usage.returncode == 2 and "usage" in usage.stderr


@pytest.mark.parametrize("pin,want", [(False, "lr: 0.0005"), (True, "lr: 0.001")])
def test_resume_reset_lr_semantics(fake_data, tmp_path, pin, want):
    """tests/test_driver.py's case: reset_lr rebases the rate at resume,
    the schedule reasserts at the next epoch; reset_lr_pin keeps args.lr."""
    ckpt_dir = tmp_path / "ckpt"
    cfg = _config(fake_data, ckpt_dir, lrs="0.001,0.0005",
                  lr_switch_epochs="0,1")

    def lr_lines():
        return [ln.strip() for ln in open(ckpt_dir / "log") if ln.startswith("lr: ")]

    _run(dict(cfg, epochs=1))
    assert lr_lines() == ["lr: 0.001"]
    saved = torch.load(ckpt_dir / "checkpoint.pt", weights_only=True)
    assert saved["meta"]["epoch"] == 1
    _run(dict(cfg, epochs=2, resume=True, reset_lr=True, reset_lr_pin=pin))
    log = (ckpt_dir / "log").read_text()
    assert "reset lr" in log and "=> resumed from epoch 1" in log
    assert lr_lines()[-1] == want, lr_lines()
    resumed = torch.load(ckpt_dir / "checkpoint.pt", weights_only=True)
    assert resumed["meta"]["epoch"] == 2
    assert float(resumed["state"]["opt_state"]["learning_rate"]) == \
        np.float32(float(want.split()[1]))
    assert int(resumed["state"]["step"]) == 2 * int(saved["state"]["step"])


def test_ckpt_dir_overwrite_guard(fake_data, tmp_path):
    ckpt_dir = tmp_path / "existing"
    ckpt_dir.mkdir()
    (ckpt_dir / "log").write_text("previous run")
    with pytest.raises(RuntimeError, match="force_overwrite"):
        _run(_config(fake_data, ckpt_dir))
    assert (ckpt_dir / "log").read_text() == "previous run"


def _state(seed):
    rng = np.random.RandomState(seed)

    def tree():
        return {"bcn1.conv0_kernel": torch.from_numpy(
                    rng.randn(15, 68, 64).astype(np.float32)),
                "conv4.dense0_bias": torch.from_numpy(rng.randn(3).astype(np.float32))}
    return TrainState(params=tree(),
                      opt_state=AdamState(mu=tree(), nu=tree(),
                                          count=torch.tensor(7, dtype=torch.int32),
                                          learning_rate=torch.tensor(3e-4)),
                      step=torch.tensor(7, dtype=torch.int32))


def test_checkpoint_save_restore_is_bit_identical(tmp_path):
    io = CheckpointIO(str(tmp_path / "ck"))
    state = _state(0)
    for epoch in (1, 2, 11, 12):
        io.save(state, epoch, 0.5 + epoch, is_best=(epoch == 2))
    names = sorted(os.listdir(io.ckpt_dir))
    assert names == ["checkpoint.pt", "checkpoint_1.pt", "checkpoint_11.pt",
                     "model_best.pt"]
    assert io.exists() and io.exists("checkpoint_11") and not io.exists("checkpoint_2")
    for name, epoch in (("checkpoint", 12), ("checkpoint_1", 1),
                        ("model_best", 2)):
        got, got_epoch, min_loss = io.restore(_state(1), name)
        assert (got_epoch, min_loss) == (epoch, 0.5 + epoch)
        for k in state.params:
            for a, b in ((got.params, state.params), (got.opt_state.mu, state.opt_state.mu),
                         (got.opt_state.nu, state.opt_state.nu)):
                assert torch.equal(a[k], b[k]) and a[k].dtype == torch.float32
        assert int(got.step) == 7 and int(got.opt_state.count) == 7
        assert got.opt_state.learning_rate.dtype == torch.float32
        assert float(got.opt_state.learning_rate) == np.float32(3e-4)
    wrong = _state(2)
    wrong.params["bcn1.conv0_kernel"] = torch.zeros(15, 67, 64)
    with pytest.raises(ValueError, match="do not match"):
        io.restore(wrong)


def test_yaml_is_needed_only_to_parse_a_file(fake_data, tmp_path, monkeypatch):
    """A Config built from a dict runs without the yaml package."""
    monkeypatch.setitem(sys.modules, "yaml", None)
    cfg = _config(fake_data, tmp_path / "ck", epochs=1)
    assert np.isfinite(_run(cfg)["min_val_epe3d"])
    with pytest.raises(ImportError):
        parse_args_from_yaml(str(tmp_path / "any.yaml"))
