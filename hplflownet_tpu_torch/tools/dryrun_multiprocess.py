"""A data-parallel train step, or a lattice-sharded forward, across processes.

    python -m hplflownet_tpu_torch.tools.dryrun_multiprocess [--procs 2] \
        [--device cpu] [--case '{"mode": "lattice"}'] [--out f.json]

Port of ``tools/dryrun_multiprocess.py``.  The parent starts ``--procs``
fresh interpreters (never a fork of a process with CUDA up).  Each joins
one job through ``parallel.initialize`` with an explicit coordinator on
this host.  In the default mode (``"dp"``) each builds the global mesh,
makes the same seeded global batch and loads only its
``process_local_batch_slice``, and takes one ``make_dp_train_step`` step;
the parent checks that every rank reports the same finite loss and the
same parameters after Adam (a hash of their bytes).  In mode
``"lattice"`` the ranks form one ``lattice`` axis and run
``parallel.lattice_sharded_forward`` on the batch's first pair, counting
kernel 1's launches and output rows and the forward's FLOPs
(``torch.utils.flop_counter``); with ``call_tol`` in the case, each rank
also records every kernel call of one sharded forward and holds it
against its plain version on the same inputs
(``tools.step_calls.check_calls``); the parent checks that every rank
returns the same finite flow.  It prints one JSON line (the keys of the
JAX tool's ``MULTIPROC.json`` and more); ``--out`` also writes it there,
and nothing else is written.

The default case is the JAX tool's: HPLFlowNetShallow (SFM5), capacities
``[128, 128, 128, 96, 64]``, 32 random points a cloud, global batch 4, Adam
at lr 1e-3.  Ranks run on the card unless ``--device cpu``: NCCL when
every rank has a card of its own, gloo otherwise (NCCL refuses two ranks
on one card), gloo on the CPU.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import math
import os
import os.path as osp
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["DEFAULT_CASE", "TABLES", "make_case", "host_ms", "free_port", "run",
           "main"]

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

# tools/dryrun_multiprocess.py's case
DEFAULT_CASE = dict(
    arch="HPLFlowNetShallow",
    sfm=[[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
         [0.0625, 1, 1, 1]],
    capacities=[128, 128, 128, 96, 64], num_points=32, global_batch=4,
    data="randn",        # or "frustum": lattice.capacity's synthetic clouds
    seed=0, lr=1e-3, compute_dtype="float32",
    valid1=None,         # per sample, the share of points left valid
    valid2=None,
    lattice_axis=1,      # ranks sharing a data index repeat its work
    steps=1,             # steps (forwards) after the first are timed only
    mode="dp",           # or "lattice": lattice_sharded_forward
    call_tol=None)       # lattice: {"bf16": x, "f32": y}, kernel vs plain


# the lattice tables a sharded build splits over the taps
TABLES = ("pc1_blur_neighbors", "pc2_blur_neighbors", "pc1_corr_indices",
          "pc2_corr_uniq")


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def _batch(case: dict) -> dict:
    """The seeded global batch, numpy."""
    b, n = case["global_batch"], case["num_points"]
    if case["data"] == "frustum":
        from ..lattice.capacity import synthetic_frustum_clouds
        pc1, pc2 = synthetic_frustum_clouds(b, n, seed=case["seed"])
    else:
        rng = np.random.RandomState(case["seed"])
        pc1 = rng.randn(b, n, 3).astype(np.float32) * 2.0
        pc2 = pc1 + 0.05 * rng.randn(b, n, 3).astype(np.float32)
    batch = {"pc1": pc1, "pc2": pc2, "sf": pc2 - pc1}
    for key in ("valid1", "valid2"):
        mask = np.ones((b, n), bool)
        for i, share in enumerate(case[key] or ()):
            mask[i, int(round(share * n)):] = False
        batch[key] = mask
    return batch


def make_case(case: dict, device):
    """-> (model, spec, global batch): the case's model with seeded
    weights (``params.seeded_jax_params``) on ``device``, its lattice spec
    and its seeded global batch (numpy).  Keys missing from ``case`` take
    DEFAULT_CASE's values."""
    case = dict(DEFAULT_CASE, **case)
    from ..models import MODELS
    from ..params import params_from_jax, seeded_jax_params
    from ..pipeline import make_lattice_spec
    model = MODELS[case["arch"]](scales_filter_map=case["sfm"],
                                 compute_dtype=case["compute_dtype"],
                                 device=device)
    params_from_jax(seeded_jax_params(model, case["seed"]), model)
    spec = make_lattice_spec(case["sfm"], capacities=case["capacities"])
    return model, spec, _batch(case)


def _params_sha256(params: dict) -> str:
    h = hashlib.sha256()
    for k in sorted(params):
        h.update(k.encode())
        h.update(params[k].detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def host_ms(fn, device) -> tuple:
    """-> (``fn()``, its ms on the host clock up to a synchronise of
    ``device``): how a rank's steps and forwards are timed."""
    device = torch.device(device)
    t = time.perf_counter()
    out = fn()
    _sync(device)
    return out, (time.perf_counter() - t) * 1e3


def worker(rank: int, world: int, port: int, case: dict, device: str,
           backend: str, save_dir: str | None, timeout: float) -> dict:
    from ..parallel import initialize
    dev = initialize(coordinator_address=f"127.0.0.1:{port}",
                     num_processes=world, process_id=rank, backend=backend,
                     device="cpu" if device == "cpu" else None,
                     timeout=timeout)
    try:
        res = _MODES[case["mode"]](rank, case, dev, save_dir)
    finally:
        dist.destroy_process_group()
    return dict(res, rank=rank, backend=backend, device=str(dev))


def _lattice_worker(rank: int, case: dict, dev, save_dir: str | None) -> dict:
    from torch.utils.flop_counter import FlopCounterMode
    from ..kernels import count_launches
    from ..kernels.stencil import stencil_gather_matmul
    from ..lattice import build_pyramid, probe_sharding
    from ..parallel import lattice_sharded_forward, make_mesh
    from .step_calls import check_calls, recorded_calls
    mesh = make_mesh(axis_names=("lattice",))
    model, spec, batch = make_case(case, dev)
    pc1, pc2 = (torch.from_numpy(batch[k][0]).to(dev) for k in ("pc1", "pc2"))
    fn = lattice_sharded_forward(model, spec, mesh)
    stencil_gather_matmul.rows = 0
    (flow, launches), first = host_ms(
        lambda: count_launches(lambda: fn(None, pc1, pc2)), dev)
    rows = stencil_gather_matmul.rows
    times = [first] + [host_ms(lambda: fn(None, pc1, pc2), dev)[1]
                       for _ in range(case["steps"] - 1)]
    with FlopCounterMode(display=False) as flops:
        fn(None, pc1, pc2)
    calls = None
    if case["call_tol"]:
        with recorded_calls() as recorded:
            fn(None, pc1, pc2)
        calls = check_calls(recorded, case["call_tol"])
        del recorded
    if save_dir:
        with torch.inference_mode(), probe_sharding(mesh):
            scales = build_pyramid(spec, pc1, pc2, adjoint_plans=False)
        tables = {f"{s}.{k}": getattr(sp, k).cpu() for s, sp in enumerate(scales)
                  for k in TABLES}
        torch.save({"flow": flow.cpu(), "tables": tables},
                   osp.join(save_dir, f"rank{rank}.pt"))
    out = flow.detach().cpu().contiguous()
    return {"flow_sha256": hashlib.sha256(out.numpy().tobytes()).hexdigest(),
            "finite": bool(torch.isfinite(out).all()),
            "mesh": mesh.shape, "launches": launches, "kernel1_rows": rows,
            "flops": flops.get_total_flops(), "calls": calls,
            "first_step_ms": times[0],
            "step_ms": float(np.median(times[1:])) if len(times) > 1 else None}


def _dp_worker(rank: int, case: dict, dev, save_dir: str | None) -> dict:
    from ..kernels import count_launches
    from ..parallel import (global_mesh, make_dp_train_step,
                            process_local_batch_slice, shard_batch)
    mesh = global_mesh(lattice_axis=case["lattice_axis"])
    sl = process_local_batch_slice(case["global_batch"], mesh)
    model, spec, batch = make_case(case, dev)
    local = shard_batch({k: v[sl] for k, v in batch.items()}, mesh, device=dev)
    init_state, step = make_dp_train_step(model, spec, mesh, case["lr"],
                                          device=dev)
    state = init_state()
    t = time.perf_counter()
    (new, loss, overflow, grads), launches = count_launches(
        lambda: step.with_grads(state, local))
    _sync(dev)
    times = [(time.perf_counter() - t) * 1e3]
    for _ in range(case["steps"] - 1):
        t = time.perf_counter()
        step(state, local)
        _sync(dev)
        times.append((time.perf_counter() - t) * 1e3)
    if save_dir:
        torch.save({"loss": loss.cpu(), "overflow": overflow.cpu(),
                    "grads": {k: v.cpu() for k, v in grads.items()},
                    "params": {k: v.cpu() for k, v in new.params.items()}},
                   osp.join(save_dir, f"rank{rank}.pt"))
    return {"loss": float(loss), "overflow": int(overflow),
            "params_sha256": _params_sha256(new.params),
            "slice": [sl.start, sl.stop], "mesh": mesh.shape,
            "launches": launches, "first_step_ms": times[0],
            "step_ms": float(np.median(times[1:])) if len(times) > 1 else None}


_MODES = {"dp": _dp_worker, "lattice": _lattice_worker}


def _pick_backend(device: str, procs: int) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    if device == "cpu" or torch.cuda.device_count() < procs:
        return "gloo"
    return "nccl"


def free_port() -> int:
    """A TCP port on this host that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run(case: dict | None = None, procs: int = 2, device: str | None = None,
        backend: str | None = None, save_dir: str | None = None,
        timeout: float = 600.0) -> dict:
    """Start ``procs`` worker interpreters on ``case`` (DEFAULT_CASE's keys)
    and check them; -> the result (raises if a worker fails or the ranks
    disagree).  ``save_dir`` receives each rank's ``rank<i>.pt``: its loss,
    summed gradients and new parameters, or in mode "lattice" its flow and
    the sharded build's tables (``TABLES``, per scale)."""
    case = dict(DEFAULT_CASE, **(case or {}))
    if device is None:
        from ..device import resolve_device
        device = resolve_device(None).type
    backend = backend or _pick_backend(device, procs)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    t0 = time.time()
    with tempfile.TemporaryDirectory() as logs:
        procs_ = []
        for i in range(procs):
            log = open(osp.join(logs, f"worker{i}.log"), "w+")
            cmd = [sys.executable, "-m", "hplflownet_tpu_torch.tools.dryrun_multiprocess",
                   "--worker", str(i), "--procs", str(procs), "--port", str(port),
                   "--device", device, "--backend", backend,
                   "--case", json.dumps(case), "--timeout", str(timeout)]
            if save_dir:
                cmd += ["--save-dir", save_dir]
            procs_.append((subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT,
                                            env=env, cwd=ROOT), log))
        outs = []
        try:
            for p, log in procs_:
                p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
        finally:
            for p, log in procs_:
                if p.poll() is None:
                    p.kill()
                    p.wait()
                log.seek(0)
                outs.append(log.read())
                log.close()
    failed = [i for i, (p, _) in enumerate(procs_) if p.returncode != 0]
    if failed:
        raise RuntimeError(f"workers {failed} failed:\n"
                           + "\n".join(outs[i][-4000:] for i in failed))
    ranks = {}
    for out in outs:
        for line in out.splitlines():
            if line.startswith("WORKER "):
                r = json.loads(line[len("WORKER "):])
                ranks[r["rank"]] = r
    if sorted(ranks) != list(range(procs)):
        raise RuntimeError(f"missing worker results: {sorted(ranks)}")
    rows = [ranks[i] for i in range(procs)]
    common = {"ok": True, "n_processes": procs, "devices_per_process": 1,
              "backend": backend, "device": rows[0]["device"],
              "mesh": rows[0]["mesh"],
              "launches": [r["launches"] for r in rows],
              "first_step_ms": [r["first_step_ms"] for r in rows],
              "step_ms": [r["step_ms"] for r in rows],
              "elapsed_s": time.time() - t0}
    if case["mode"] == "lattice":
        if len({r["flow_sha256"] for r in rows}) != 1 or not rows[0]["finite"]:
            raise AssertionError("ranks return different flows, or a flow "
                                 "that is not finite")
        return dict(common, flow_sha256=rows[0]["flow_sha256"],
                    kernel1_rows=[r["kernel1_rows"] for r in rows],
                    flops=[r["flops"] for r in rows],
                    calls=[r["calls"] for r in rows])
    losses = [r["loss"] for r in rows]
    if len(set(losses)) != 1 or not math.isfinite(losses[0]):
        raise AssertionError(f"ranks disagree or the loss is not finite: {losses}")
    if len({r["params_sha256"] for r in rows}) != 1:
        raise AssertionError("ranks hold different parameters after the step")
    return dict(common, global_batch=case["global_batch"], loss=losses[0],
                overflow=rows[0]["overflow"],
                slices=[r["slice"] for r in rows],
                params_sha256=rows[0]["params_sha256"])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu, or the card (the default)")
    ap.add_argument("--backend", default=None, choices=(None, "gloo", "nccl"))
    ap.add_argument("--case", default=None,
                    help="JSON object overriding DEFAULT_CASE's keys")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    ap.add_argument("--save-dir", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--worker", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    case = json.loads(args.case) if args.case else {}
    if args.worker is not None:
        if args.device == "cpu":
            torch.set_num_threads(1)
        res = worker(args.worker, args.procs, args.port,
                     dict(DEFAULT_CASE, **case), args.device, args.backend,
                     args.save_dir, args.timeout)
        print("WORKER " + json.dumps(res), flush=True)
        return 0
    result = run(case, args.procs, args.device, args.backend, args.save_dir,
                 args.timeout)
    line = json.dumps(result)
    if args.out:
        with open(args.out, "w") as fd:
            fd.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
