"""The port's data-parallel layer (``hplflownet_tpu_torch.parallel``) on the CPU.

* Two gloo processes take one ``make_dp_train_step`` step on
  tests/test_sharding.py's shapes (HPLFlowNetShallow, SFM5, 48 points,
  capacities [256, 256, 256, 128, 128]) at global batch 4, with samples
  whose valid counts differ (one all-False, as the loader pads), held to
  the port's single-process step on the whole batch: the loss within 1e-6
  relative, each gradient leaf within 1e-5 of its max, the parameters
  after Adam within test_sharding.py's bounds (max 2.5e-3 at lr 1e-3,
  under 0.1% of entries above 1e-4), and both ranks bit-identical.
* ``initialize`` is a no-op without a launcher's environment, joins from
  ``torchrun``'s, and raises on a bad explicit coordinator
  (test_sharding.py:123-190).
* ``global_mesh`` and ``process_local_batch_slice`` (test_sharding.py:214-224),
  and the ``dryrun_multiprocess`` CLI.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from hplflownet_tpu_torch.parallel import (global_mesh, initialize, make_mesh,
                                           process_local_batch_slice)
from hplflownet_tpu_torch.tools import dryrun_multiprocess as dryrun
from hplflownet_tpu_torch.train.step import loss_and_grad, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# test_sharding.py's setup(b=4, n=48); sample 1 is padding (all False)
CASE = dict(num_points=48, capacities=[256, 256, 256, 128, 128],
            valid1=[1.0, 0.0, 0.75, 0.5], valid2=[1.0, 0.0, 1.0, 1.0])
ENV_KEYS = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK",
            "SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID")


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _python(code: str, env: dict | None = None, timeout: float = 120):
    base = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    base.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **(env or {}))
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, env=base, cwd=ROOT)


def test_two_process_dp_step_matches_single_process(tmp_path):
    result = dryrun.run(CASE, procs=2, device="cpu", save_dir=str(tmp_path),
                        timeout=300)
    assert result["slices"] == [[0, 2], [2, 4]]
    ranks = [torch.load(tmp_path / f"rank{i}.pt") for i in range(2)]
    for key in ("grads", "params"):
        for k, v in ranks[0][key].items():
            assert torch.equal(v, ranks[1][key][k]), (key, k)

    case = dict(dryrun.DEFAULT_CASE, **CASE)
    model, spec, batch = dryrun.make_case(case, "cpu")
    counts = batch["valid1"].sum(1)
    assert len(set(counts[:2].tolist())) == 2 and counts[:2].sum() != counts[2:].sum()
    init_state, step = make_train_step(model, spec, case["lr"], device="cpu")
    state = init_state()
    loss, overflow, grads = loss_and_grad(model, spec, state.params, batch)
    new, loss_step, _ = step.with_overflow(state, batch)
    assert int(overflow) == 0 and int(ranks[0]["overflow"]) == 0
    assert float(loss_step) == float(loss)
    np.testing.assert_allclose(result["loss"], float(loss), rtol=1e-6)
    for k, g in grads.items():
        d = float((ranks[0]["grads"][k] - g).abs().max())
        assert d <= 1e-5 * float(g.abs().max()) + 1e-12, (k, d)
    for k, p in new.params.items():
        diff = (ranks[0]["params"][k] - p).abs()
        assert float(diff.max()) <= 2.5e-3, k
        assert float((diff > 1e-4).float().mean()) < 1e-3, k


def test_ranks_on_the_lattice_axis_repeat_the_work(tmp_path):
    """A 1 x 2 (data, lattice) mesh: both ranks load the whole batch and
    sum over a data group of one, so each equals the single-process step
    bit for bit."""
    result = dryrun.run(dict(CASE, lattice_axis=2), procs=2, device="cpu",
                        save_dir=str(tmp_path), timeout=300)
    assert result["mesh"] == {"data": 1, "lattice": 2}
    assert result["slices"] == [[0, 4], [0, 4]]
    model, spec, batch = dryrun.make_case(CASE, "cpu")
    init_state, step = make_train_step(model, spec, dryrun.DEFAULT_CASE["lr"],
                                       device="cpu")
    new, loss, _ = step.with_overflow(init_state(), batch)
    rank = torch.load(tmp_path / "rank1.pt")
    assert torch.equal(rank["loss"], loss)
    for k, p in new.params.items():
        assert torch.equal(rank["params"][k], p), k


def test_initialize_is_a_no_op_without_a_job(monkeypatch):
    for k in ENV_KEYS:
        monkeypatch.delenv(k, raising=False)
    assert initialize() is None
    assert not torch.distributed.is_initialized()


def test_initialize_joins_from_torchrun_environment():
    code = ("import torch.distributed as dist\n"
            "from hplflownet_tpu_torch.parallel import initialize, global_mesh\n"
            "dev = initialize(device='cpu', timeout=30)\n"
            "assert dist.is_initialized() and dist.get_backend() == 'gloo', dev\n"
            "print(global_mesh().shape, dist.get_world_size())\n"
            "dist.destroy_process_group()\n")
    r = _python(code, env=dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                               MASTER_ADDR="127.0.0.1",
                               MASTER_PORT=str(dryrun.free_port())))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split("\n")[0] == "{'data': 1, 'lattice': 1} 1"


@pytest.mark.parametrize("address, kwargs, error", [
    ("127.0.0.1:{port}", dict(num_processes=2, process_id=1), "RAISED"),
    ("no-port-here", dict(num_processes=2, process_id=1), "ValueError"),
    ("127.0.0.1:{port}", dict(num_processes=2), "ValueError"),
    ("127.0.0.1:{port}", dict(num_processes=2, process_id=2), "ValueError"),
])
def test_initialize_propagates_explicit_coordinator_errors(address, kwargs, error):
    """Rank 1 of 2 with no coordinator listening must fail (here after a
    3 s timeout), never fall back to a single-process run; malformed
    arguments raise ValueError."""
    address = address.format(port=dryrun.free_port())
    code = ("import torch.distributed as dist\n"
            "from hplflownet_tpu_torch.parallel import initialize\n"
            "try:\n"
            f"    initialize(coordinator_address={address!r}, device='cpu', "
            f"timeout=3, **{kwargs!r})\n"
            "except ValueError:\n"
            "    print('ValueError')\n"
            "except Exception as e:\n"
            "    print('RAISED', type(e).__name__)\n"
            "assert not dist.is_initialized()\n")
    r = _python(code, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split()[0] == error, r.stdout


def test_distributed_helpers_single_process():
    assert initialize() is None
    mesh = global_mesh()
    assert mesh.shape == {"data": 1, "lattice": 1} and mesh.device_mesh is None
    assert mesh.coordinate() == {"data": 0, "lattice": 0}
    assert mesh.group("data") is None
    assert process_local_batch_slice(8) == slice(0, 8)
    assert process_local_batch_slice(8, mesh) == slice(0, 8)
    assert make_mesh(axis_names=("data", "lattice")).shape == {"data": 1, "lattice": 1}
    with pytest.raises(ValueError, match="ranks"):
        make_mesh((2, 1), ("data", "lattice"))
    with pytest.raises(ValueError):
        global_mesh(lattice_axis=2)


def test_meshes_and_slices_across_two_ranks():
    """Two gloo ranks: a 2 x 1 and a 1 x 2 mesh, each rank's slice of a
    global batch of 8, and a sum over the lattice axis's group."""
    code = r"""
import sys, torch, torch.distributed as dist
from hplflownet_tpu_torch.parallel import (initialize, global_mesh,
                                           process_local_batch_slice)
initialize(coordinator_address="127.0.0.1:" + sys.argv[1], num_processes=2,
           process_id=int(sys.argv[2]), device="cpu", timeout=60)
dp = global_mesh()
lat = global_mesh(lattice_axis=2)
x = torch.ones(1)
dist.all_reduce(x, group=lat.group("lattice"))
print(dp.shape, lat.shape, process_local_batch_slice(8),
      process_local_batch_slice(8, dp), process_local_batch_slice(8, lat),
      lat.coordinate(), float(x))
dist.destroy_process_group()
"""
    port = str(dryrun.free_port())
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", code, port, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env, cwd=ROOT) for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, err[-2000:]
            outs.append(out.strip())
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, out in enumerate(outs):
        assert out == (f"{{'data': 2, 'lattice': 1}} {{'data': 1, 'lattice': 2}} "
                       f"slice({4 * i}, {4 * i + 4}, None) "
                       f"slice({4 * i}, {4 * i + 4}, None) slice(0, 8, None) "
                       f"{{'data': 0, 'lattice': {i}}} 2.0"), out


def test_dryrun_multiprocess_cli(tmp_path):
    """The CLI on the JAX tool's case writes only its --out file."""
    out = tmp_path / "multiproc.json"
    before = open(os.path.join(ROOT, "MULTIPROC.json")).read()
    env = {k: v for k, v in os.environ.items() if k not in ENV_KEYS}
    env.update(PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-m",
                        "hplflownet_tpu_torch.tools.dryrun_multiprocess",
                        "--device", "cpu", "--timeout", "300", "--out", str(out)],
                       capture_output=True, text=True, timeout=360, env=env,
                       cwd=str(tmp_path))
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert json.load(open(out)) == line
    assert line["ok"] and line["n_processes"] == 2 and line["global_batch"] == 4
    assert np.isfinite(line["loss"]) and line["backend"] == "gloo"
    assert line["slices"] == [[0, 2], [2, 4]]
    assert open(os.path.join(ROOT, "MULTIPROC.json")).read() == before
