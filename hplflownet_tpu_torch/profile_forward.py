"""Where the flagship forward's time goes on the card.

    python -m hplflownet_tpu_torch.profile_forward [--points 8192]
        [--dtype bfloat16] [--reps 5] [--out profile.json]

Runs ``pipeline.flow_forward`` on one synthetic FT3D-like pair at full
width (the 7-scale map and the flagship capacities), with seeded weights,
and reports:

* the forward's time per pair with CUDA events, and the same split into
  the lattice build and the model;
* a ``torch.profiler`` trace of a few forwards: device time by kernel,
  grouped (the port's two kernels, dense matmuls, sorts and searches, the
  rest), the number of kernels launched per forward, and the device's idle
  share (1 - device busy time / elapsed time).

Needs a CUDA card; prints one JSON object as its last line (and writes
the full result to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import torch

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CAPACITIES = [25600, 31872, 12928, 3584, 896, 256, 128]

_GROUPS = (("stencil_gather_matmul", ("stencil_bf16_kernel", "stencil_f32_kernel")),
           ("rank_reduce", ("rank_reduce_kernel",)),
           ("dense matmul", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
           ("sort / search", ("sort", "radix", "searchsorted", "scan")),
           ("gather / index", ("index", "gather", "scatter")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"


def _cuda_ms(fn, reps):
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")

    from .lattice import build_pyramid
    from .lattice.capacity import synthetic_frustum_clouds
    from .models import HPLFlowNet
    from .params import params_from_jax, seeded_jax_params
    from .pipeline import flow_forward, make_lattice_spec

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pc1, pc2 = synthetic_frustum_clouds(1, args.points, seed=args.seed)
    pc1, pc2 = pc1[0], pc2[0]
    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype=args.dtype, device=dev)
    params_from_jax(seeded_jax_params(model, args.seed), model)
    t1 = torch.from_numpy(pc1).to(dev)
    t2 = torch.from_numpy(pc2).to(dev)

    def fwd():
        return flow_forward(model, spec, pc1, pc2, adjoint_plans=False)

    def build():
        with torch.inference_mode():
            return build_pyramid(spec, t1, t2, adjoint_plans=False)

    for _ in range(2):
        fwd()
    scales = build()
    fwd_ms = _cuda_ms(fwd, args.reps)
    build_ms = _cuda_ms(build, args.reps)
    with torch.inference_mode():
        model_ms = _cuda_ms(lambda: model(t1, t2, scales), args.reps)

    from torch.profiler import ProfilerActivity, profile
    n_prof = 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            fwd()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof

    kernels: dict = {}
    n_launch = 0
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        if evt.device_type != torch.autograd.DeviceType.CUDA or dev_us <= 0:
            continue
        kernels[evt.key] = (dev_us / 1e3 / n_prof, evt.count / n_prof)
        n_launch += evt.count / n_prof
    busy_ms = sum(ms for ms, _ in kernels.values())
    groups: dict = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]

    print(f"device: {torch.cuda.get_device_name(0)} ({_card_line()})")
    print(f"forward {fwd_ms:.3f} ms/pair ({1e3 / fwd_ms:.2f} pairs/s); lattice "
          f"build {build_ms:.3f} ms, model {model_ms:.3f} ms (CUDA events, "
          f"{args.reps} reps, {args.dtype})")
    print(f"profiled: {wall_ms:.3f} ms/pair wall, {busy_ms:.3f} ms device busy, "
          f"idle share {1 - busy_ms / wall_ms:.3f}, {n_launch:.0f} kernels per pair")
    for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {ms:9.3f} ms  {cnt:6.0f} launches")
    for name, (ms, cnt) in top:
        print(f"    {ms:9.4f} ms {cnt:6.0f}x  {name[:110]}")

    result = dict(device=torch.cuda.get_device_name(0), dtype=args.dtype,
                  points=args.points, forward_ms=fwd_ms, build_ms=build_ms,
                  model_ms=model_ms, profiled_wall_ms=wall_ms,
                  device_busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
                  kernels_per_pair=n_launch,
                  groups={g: {"ms": v[0], "launches": v[1]}
                          for g, v in groups.items()},
                  top=[{"name": n, "ms": v[0], "launches": v[1]} for n, v in top])
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fd:
            json.dump(result, fd, indent=1)
    print(json.dumps({k: result[k] for k in (
        "forward_ms", "build_ms", "model_ms", "device_busy_ms", "idle_share",
        "kernels_per_pair")}))
    return result


if __name__ == "__main__":
    main()
