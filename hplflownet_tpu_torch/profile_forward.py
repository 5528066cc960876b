"""Where the forward's (or train step's) time goes on the card, per model.

    python -m hplflownet_tpu_torch.profile_forward [--points 8192]
        [--dtype bfloat16] [--reps 5] [--train] [--out profile.json]
        [--arch HPLFlowNet|HPLFlowNetShallow]

Runs ``pipeline.flow_forward`` on one synthetic FT3D-like pair at full
width (the 7-scale map and the flagship capacities, or with ``--arch
HPLFlowNetShallow`` the shallow model's 5-scale map and capacities), with
seeded weights, and reports:

* the forward's time per pair with CUDA events, and the same split into
  the lattice build and the model;
* a ``torch.profiler`` trace of a few forwards: device time by kernel,
  grouped (the port's kernels, dense matmuls, sorts and searches, the
  rest) and the number of kernels launched per forward (no idle share:
  the profiler slows the host, so the profiled wall overstates it).

With ``--train`` it profiles the train step instead
(``train.step.make_train_step``: batch 1, Adam at lr 1e-4, overflow skip):
ms/step with CUDA events and the same trace per step.

Needs a CUDA card; prints one JSON object as its last line (and writes
the full result to ``--out`` when given).
"""

from __future__ import annotations

import argparse
import json
import os
import time

import torch

from .tools.timing import ARCHS as _ARCHS, card_line, time_ms

_GROUPS = (("stencil_gather_matmul", ("stencil_wgmma_kernel", "stencil_f32_kernel")),
           ("stencil_dkernel", ("dkernel_wgmma", "dkernel_f32", "sum_slabs")),
           ("stencil_tap_tables_sum", ("tap_tables_kernel",)),
           ("blocked_rank_reduce", ("blocked_rank_reduce_kernel",)),
           ("rank_reduce", ("rank_reduce_kernel",)),
           ("adam (foreach)", ("multi_tensor_apply", "foreach")),
           ("dense matmul", ("gemm", "cutlass", "xmma", "sm90_", "ampere_")),
           ("sort / search", ("sort", "radix", "searchsorted", "scan")),
           ("gather / index", ("index", "gather", "scatter")))


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS:
        if any(k.lower() in low for k in keys):
            return group
    return "other"


def _trace(fn, n_prof: int, device="cuda"):
    """torch.profiler over ``n_prof`` calls: (wall ms per call, {kernel name:
    (device ms per call, launches per call)}).  On the CPU the entries are
    the operators' self times on the host instead (no device number)."""
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        sync()
        t0 = time.perf_counter()
        for _ in range(n_prof):
            fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_prof
    kernels: dict = {}
    want = torch.autograd.DeviceType.CUDA if cuda else torch.autograd.DeviceType.CPU
    for evt in prof.key_averages():
        if cuda:
            us = getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0))
        else:
            us = evt.self_cpu_time_total
        if evt.device_type != want or us <= 0:
            continue
        kernels[evt.key] = (us / 1e3 / n_prof, evt.count / n_prof)
    return wall_ms, kernels


def _report(kernels: dict, wall_ms: float, unit: str) -> dict:
    busy_ms = sum(ms for ms, _ in kernels.values())
    n_launch = sum(cnt for _, cnt in kernels.values())
    groups: dict = {}
    for name, (ms, cnt) in kernels.items():
        g = groups.setdefault(_group(name), [0.0, 0.0])
        g[0] += ms
        g[1] += cnt
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:25]
    print(f"profiled: {wall_ms:.3f} ms/{unit} wall, {busy_ms:.3f} ms device busy, "
          f"{n_launch:.0f} kernels per {unit}")
    for g, (ms, cnt) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {g:24s} {ms:9.3f} ms  {cnt:6.0f} launches")
    for name, (ms, cnt) in top:
        print(f"    {ms:9.4f} ms {cnt:6.0f}x  {name[:110]}")
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                **{f"kernels_per_{unit}": n_launch},
                groups={g: {"ms": v[0], "launches": v[1]} for g, v in groups.items()},
                top=[{"name": n, "ms": v[0], "launches": v[1]} for n, v in top])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--train", action="store_true",
                    help="profile the train step instead of the forward")
    ap.add_argument("--arch", choices=sorted(_ARCHS), default="HPLFlowNet",
                    help="the model, at its map and capacities")
    ap.add_argument("--out", default=None,
                    help="also write the result as JSON to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward needs a CUDA card")

    from .lattice import build_pyramid
    from .lattice.capacity import synthetic_frustum_clouds
    from .models import MODELS
    from .params import params_from_jax, seeded_jax_params
    from .pipeline import flow_forward, make_lattice_spec
    from .train.step import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    pc1, pc2 = synthetic_frustum_clouds(1, args.points, seed=args.seed)
    sfm, capacities = _ARCHS[args.arch]
    spec = make_lattice_spec(sfm, capacities)
    model = MODELS[args.arch](sfm, compute_dtype=args.dtype, device=dev)
    params_from_jax(seeded_jax_params(model, args.seed), model)
    t1 = torch.from_numpy(pc1[0]).to(dev)
    t2 = torch.from_numpy(pc2[0]).to(dev)
    result = dict(device=torch.cuda.get_device_name(0), card=card_line(),
                  arch=args.arch, dtype=args.dtype, points=args.points)
    print(f"device: {result['device']} ({result['card']})")

    if args.train:
        batch = dict(pc1=t1[None], pc2=t2[None], sf=(t2 - t1)[None],
                     valid1=torch.ones((1, args.points), dtype=torch.bool, device=dev),
                     valid2=torch.ones((1, args.points), dtype=torch.bool, device=dev))
        init, step = make_train_step(model, spec, learning_rate=1e-4,
                                     on_overflow="skip", device=dev)
        state = [init()]

        def one():
            state[0], _ = step(state[0], batch)

        result["train_ms"] = time_ms(one, dev, args.reps, warmup=2)
        print(f"train step {result['train_ms']:.3f} ms/step "
              f"({1e3 / result['train_ms']:.2f} train pairs/s; CUDA events, "
              f"{args.reps} reps, {args.dtype})")
        wall_ms, kernels = _trace(one, 3)
        result.update(_report(kernels, wall_ms, "step"))
        keys = ("train_ms", "device_busy_ms", "kernels_per_step")
    else:
        def fwd():
            return flow_forward(model, spec, pc1[0], pc2[0], adjoint_plans=False)

        def build():
            with torch.inference_mode():
                return build_pyramid(spec, t1, t2, adjoint_plans=False)

        result["forward_ms"] = time_ms(fwd, dev, args.reps, warmup=2)
        scales = build()
        result["build_ms"] = time_ms(build, dev, args.reps, warmup=0)
        with torch.inference_mode():
            result["model_ms"] = time_ms(lambda: model(t1, t2, scales), dev,
                                         args.reps, warmup=0)
        print(f"forward {result['forward_ms']:.3f} ms/pair "
              f"({1e3 / result['forward_ms']:.2f} pairs/s); lattice build "
              f"{result['build_ms']:.3f} ms, model {result['model_ms']:.3f} ms "
              f"(CUDA events, {args.reps} reps, {args.dtype})")
        wall_ms, kernels = _trace(fwd, 3)
        result.update(_report(kernels, wall_ms, "pair"))
        keys = ("forward_ms", "build_ms", "model_ms", "device_busy_ms",
                "kernels_per_pair")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fd:
            json.dump(result, fd, indent=1)
    print(json.dumps({k: result[k] for k in keys}))
    return result


if __name__ == "__main__":
    main()
