"""Learnability proof-of-life: train a model on synthetic scene flow.

    python -m hplflownet_tpu_torch.tools.train_synthetic [--steps 6000] \
        [--arch HPLFlowNetShallow] [--device cpu] [--out curve.json] \
        [--save-params params.pkl] [--init-params params.pkl]

Port of ``tools/train_synthetic.py``: a seeded FT3D-like set (surfaces of
``lattice.capacity.synthetic_frustum_clouds`` moved by patchwise rigid-ish
flows), a held-out split (or ``--overfit N``: train and evaluate on the
same N pairs), pairs whose lattice build would overflow redrawn, and the
held-out EPE3D every ``--eval-every`` steps under a piecewise or a
warm-up + cosine schedule.  A gradient bug that only slows learning shows
as a flat curve.

Prints one JSON line (initial and final held-out EPE3D, their ratio, the
steps that overflowed, the train rate); ``--out`` writes the whole curve
there.  ``--save-params`` writes the parameters as a pickle in the JAX
layout (``{"params": {module: {name: array}}}``, float32 numpy), which
either package's tools read; ``--init-params`` starts from such a pickle
(with a fresh Adam state).  Runs on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys
import time

import numpy as np
import torch

from ..device import resolve_device
from ..lattice import build_pyramid
from ..lattice.capacity import (measured_default_capacities,
                                synthetic_frustum_clouds)
from ..models import MODELS
from ..models.init import reinit_params
from ..params import params_from_jax, params_to_jax
from ..pipeline import make_lattice_spec
from ..train.step import make_eval_step, make_train_step, set_learning_rate
from .timing import CAPACITIES, SFM5, SFM7

__all__ = ["make_dataset", "resample_overflowing", "nn_oracle_epe", "main"]

NUM_POINTS = 1024
TRAIN_PAIRS = 512
VAL_PAIRS = 64
# measured worst counts of the shallow model on this distribution over both
# splits at 1024 points (2853/2186/644/202/87), padded 1.2x and aligned to
# 128; scaled with the point count for other sizes
SHALLOW_BASE_CAPS = [3456, 2688, 896, 256, 128]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def make_dataset(n_pairs, n_points, seed, patches=300):
    """Pairs with patchwise flows: the task is to recover sf from (pc1, pc2).

    flow_scale 1.0 puts the motion around one lattice cell at the finest
    scale (sub-cell flows are invisible to the correlation's displacement
    taps); ``patches`` sets the flow's coherence (a dozen gives
    piecewise-rigid motion over object-sized regions).
    """
    pc1, pc2 = synthetic_frustum_clouds(n_pairs, n_points, seed=seed,
                                        flow_scale=1.0, patches=patches)
    return pc1, pc2, pc2 - pc1


def resample_overflowing(spec, pc1, pc2, seed, patches=300, device=None):
    """Redraw the pairs whose lattice build overflows (any counter).

    Static capacities are budgets; a pair that busts them is detected and
    replaced, so the training evidence carries no degradation.  Raises
    after 20 redraws of one pair that all overflow: then the capacities are
    wrong for the distribution, not the pair.  Builds on ``device`` (the
    CUDA card by default).
    """
    dev = resolve_device(device)

    def overflow(a, b):
        with torch.inference_mode():
            scales = build_pyramid(spec, torch.from_numpy(a).to(dev),
                                   torch.from_numpy(b).to(dev),
                                   adjoint_plans=False)
            return sum(int(sp.pc1_overflow + sp.pc2_overflow + sp.probe_overflow
                           + sp.stencil_overflow) for sp in scales)

    n, pts = pc1.shape[0], pc1.shape[1]
    replaced = 0
    for i in range(n):
        draw = 0
        while overflow(pc1[i], pc2[i]):
            draw += 1
            if draw > 20:
                raise RuntimeError(
                    f"pair {i}: 20 redraws all overflow the lattice budgets; "
                    "capacities too small for this distribution")
            a, b = synthetic_frustum_clouds(
                1, pts, seed=seed + 7919 * (i + 1) + draw, flow_scale=1.0,
                patches=patches)
            pc1[i], pc2[i] = a[0], b[0]
            replaced += 1
    if replaced:
        _log(f"resampled {replaced} overflowing pair(s)")
    return pc1, pc2, pc2 - pc1


def nn_oracle_epe(pc1, pc2, sf):
    """EPE3D of the nearest-neighbour oracle: each true target snapped to
    its closest pc2 point.  0 on this generator (it moves the same surface
    samples), so a held-out plateau is the model's, not the task's."""
    tot = 0.0
    n = pc1.shape[1]
    chunk = max(1, (1 << 22) // n)   # keep the (chunk, N, 3) block ~100 MB
    for i in range(pc1.shape[0]):
        mins = []
        tgt = pc1[i] + sf[i]
        for s in range(0, n, chunk):
            d = np.linalg.norm(tgt[s:s + chunk, None, :]
                               - pc2[i, None, :, :], axis=-1)
            mins.append(d.min(axis=1))
        tot += float(np.concatenate(mins).mean())
    return tot / pc1.shape[0]


def _capacities(arch: str, n_pts: int) -> tuple:
    """(scales filter map, capacities) of ``arch`` at ``n_pts`` points."""
    if arch == "HPLFlowNet":
        return SFM7, (CAPACITIES if n_pts == 8192
                      else measured_default_capacities(n_pts, SFM7))
    return SFM5, [max(128, -(-int(c * n_pts / NUM_POINTS) // 128) * 128)
                  for c in SHALLOW_BASE_CAPS]


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=6000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--device", default=None,
                    help="cpu runs the plain versions on the host")
    ap.add_argument("--out", default=None, help="write the whole curve here")
    ap.add_argument("--schedule", default="piecewise",
                    choices=("piecewise", "cosine"))
    ap.add_argument("--warmup", type=int, default=500)
    ap.add_argument("--patches", type=int, default=300)
    ap.add_argument("--save-params", default=None)
    ap.add_argument("--init-params", default=None)
    ap.add_argument("--overfit", type=int, default=0, metavar="N_PAIRS")
    ap.add_argument("--num-points", type=int, default=NUM_POINTS)
    ap.add_argument("--train-pairs", type=int, default=TRAIN_PAIRS)
    ap.add_argument("--val-pairs", type=int, default=VAL_PAIRS)
    ap.add_argument("--arch", default="HPLFlowNetShallow",
                    choices=("HPLFlowNetShallow", "HPLFlowNet"))
    return ap


def main(argv=None) -> dict:
    """Train, evaluate, write; -> the result (the ``--out`` file's keys)."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    n_pts = args.num_points
    n_train = args.overfit or args.train_pairs
    sfm, caps = _capacities(args.arch, n_pts)
    spec = make_lattice_spec(sfm, capacities=caps)
    tr1, tr2, trf = resample_overflowing(
        spec, *make_dataset(n_train, n_pts, seed=100, patches=args.patches)[:2],
        seed=100, patches=args.patches, device=dev)
    if args.overfit:
        va1, va2, vaf, n_val = tr1, tr2, trf, n_train
    else:
        va1, va2, vaf = resample_overflowing(
            spec, *make_dataset(args.val_pairs, n_pts, seed=999,
                                patches=args.patches)[:2],
            seed=999, patches=args.patches, device=dev)
        n_val = args.val_pairs

    model = MODELS[args.arch](scales_filter_map=sfm, compute_dtype="bfloat16",
                              device=dev)
    if args.init_params:
        with open(args.init_params, "rb") as fd:
            params_from_jax(pickle.load(fd), model)
        _log(f"resumed params from {args.init_params}")
    else:
        # the JAX model's own init: glorot-normal kernels, zero biases
        with torch.no_grad():
            model.load_state_dict(reinit_params(torch.Generator().manual_seed(0),
                                                model.state_dict()))
    init_state, train_step = make_train_step(model, spec, learning_rate=args.lr,
                                             device=dev)
    eval_step = make_eval_step(model, spec)
    state = init_state()

    def on_device(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]

    tr = on_device(tr1, tr2, trf)
    va = on_device(va1, va2, vaf)
    ones = torch.ones((1, n_pts), dtype=torch.bool, device=dev)

    def batch_of(split, i):
        a, b, f = split
        return {"pc1": a[i:i + 1], "pc2": b[i:i + 1], "sf": f[i:i + 1],
                "valid1": ones, "valid2": ones}

    def val_epe(params):
        return sum(float(eval_step(params, batch_of(va, i))[0])
                   for i in range(n_val)) / n_val

    oracle = nn_oracle_epe(va1, va2, vaf)
    _log(f"NN-oracle EPE3D on the val split: {oracle:.4f}")
    t0 = time.perf_counter()
    epe0 = val_epe(state.params)
    _log(f"initial held-out EPE3D {epe0:.4f} (eval {time.perf_counter() - t0:.1f}s)")
    curve = [{"step": 0, "val_epe3d": epe0}]

    order = np.random.RandomState(0).permutation(n_train)
    overflow_total = 0
    train_s = 0.0
    t0 = time.perf_counter()
    for step in range(1, args.steps + 1):
        i = int(order[step % n_train])
        state, loss, oflow = train_step.with_overflow(state, batch_of(tr, i))
        overflow_total += int(oflow)       # synchronises with the device
        if args.schedule == "cosine":
            t = min(1.0, step / args.warmup)
            frac = max(0.0, (step - args.warmup) / max(args.steps - args.warmup, 1))
            lr = args.lr * t * (0.05 + 0.95 * 0.5 * (1 + np.cos(np.pi * frac)))
            state = set_learning_rate(state, float(lr))
        elif step in (3 * args.steps // 5, 4 * args.steps // 5):
            state = set_learning_rate(
                state, args.lr * (0.3 if step == 3 * args.steps // 5 else 0.1))
        if step == 1:
            _log(f"first step {time.perf_counter() - t0:.1f}s")
        else:
            train_s += time.perf_counter() - t0
        if step % args.eval_every == 0:
            epe = val_epe(state.params)
            curve.append({"step": step, "val_epe3d": epe})
            _log(f"step {step:5d}  val EPE3D {epe:.4f} ({epe / epe0:.3f}x "
                 f"initial)  overflow {overflow_total}")
        t0 = time.perf_counter()

    out = {
        "model": args.arch, "platform": dev.type,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "points": n_pts, "overfit": bool(args.overfit),
        "train_pairs": n_train, "val_pairs": n_val,
        "lr": args.lr, "steps": args.steps, "patches": args.patches,
        "schedule": args.schedule, "capacities": caps,
        "overflow_total": overflow_total,
        "nn_oracle_epe3d": oracle,
        "initial_val_epe3d": epe0,
        "final_val_epe3d": curve[-1]["val_epe3d"],
        "final_over_initial": curve[-1]["val_epe3d"] / epe0,
        # steps after the first, evaluation excluded
        "train_steps_per_sec": ((args.steps - 1) / train_s if train_s > 0
                                else None),
        "curve": curve,
    }
    if args.save_params:
        with open(args.save_params, "wb") as fd:
            pickle.dump(params_to_jax(state.params), fd)
        _log(f"params saved to {args.save_params}")
    if args.out:
        with open(args.out, "w") as fd:
            json.dump(out, fd, indent=1)
        _log(f"curve written to {args.out}")
    print(json.dumps({k: out[k] for k in
                      ("initial_val_epe3d", "final_val_epe3d",
                       "final_over_initial", "overflow_total",
                       "train_steps_per_sec")}), flush=True)
    return out


if __name__ == "__main__":
    main()
