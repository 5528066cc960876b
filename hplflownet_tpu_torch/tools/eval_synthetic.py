"""Evaluate saved parameters through the driver on synthetic data.

    python -m hplflownet_tpu_torch.tools.eval_synthetic --params P.pkl \
        [--arch HPLFlowNet] [--num-points 8192] [--pairs 32] [--patches 12] \
        [--workdir DIR] [--device cpu] [--out metrics.json]

Port of ``tools/eval_synthetic.py``.  It writes a synthetic val set in the
processed-FlyingThings3D layout, turns a parameter pickle in the JAX layout
(``{"params": {module: {name: array}}}``, as either package's
``train_synthetic --save-params`` writes it, or the trained pickles in
``training_runs/``) into the port's checkpoint, and runs
``train.driver.run`` with ``evaluate: true`` and ``dump_visu: true``: the
six metrics (EPE3D, ACC3DS, ACC3DR, Outliers3D, EPE2D, ACC2D) by the
reference's protocol, bf16 compute, with the JAX tool's config keys and the
bench's capacities for the flagship at 8192 points (measured otherwise).

Prints the metrics as one JSON line, with the evaluation's pairs/s, its
overflowed batches and the ``visu_dir`` of the dumps
(``python -m hplflownet_tpu_torch.data.visualization <visu_dir>`` exports
them).  ``--out`` also writes it there.  ``--workdir`` defaults to a new
temporary directory.  Runs on the card unless ``--device cpu`` (the
config's ``platform: cpu``).
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle
import sys
import tempfile

import numpy as np

from ..lattice.capacity import synthetic_frustum_clouds
from ..params import params_from_jax
from .timing import CAPACITIES, SFM5, SFM7

__all__ = ["write_ft3d_layout", "main"]


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def write_ft3d_layout(root, n_pairs, n_points, seed, patches):
    """Synthetic val pairs (and one train pair) in the processed-FT3D
    on-disk layout.  The loader flips the x and z signs back
    (``data/datasets.py``), so they are stored flipped, as the reference's
    preprocessing writes them."""
    base = osp.join(root, "FlyingThings3D_subset_processed_35m")
    pc1, pc2 = synthetic_frustum_clouds(n_pairs, n_points, seed=seed,
                                        flow_scale=1.0, patches=patches)
    for split, count in (("train", 1), ("val", n_pairs)):
        for i in range(count):
            d = osp.join(base, split, f"{i:07d}")
            os.makedirs(d, exist_ok=True)
            for pc, name in ((pc1[i], "pc1"), (pc2[i], "pc2")):
                out = pc.copy()
                out[:, 0] *= -1
                out[:, 2] *= -1
                np.save(osp.join(d, f"{name}.npy"), out)
    return root


def main(argv=None) -> dict:
    """Evaluate; -> the JSON line's dict."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--params", required=True)
    ap.add_argument("--arch", default="HPLFlowNet",
                    choices=("HPLFlowNet", "HPLFlowNetShallow"))
    ap.add_argument("--num-points", type=int, default=8192)
    ap.add_argument("--pairs", type=int, default=32)
    ap.add_argument("--patches", type=int, default=12)
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--device", default=None, choices=(None, "cpu", "cuda"),
                    help="cpu runs the plain versions on the host")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..train import driver
    from ..train.checkpoint import CheckpointIO
    from ..train.step import create_train_state
    from ..utils.config import Config, postprocess

    workdir = args.workdir or tempfile.mkdtemp(prefix="eval_synth_")
    os.makedirs(workdir, exist_ok=True)
    data_root = osp.join(workdir, "data")
    write_ft3d_layout(data_root, args.pairs, args.num_points, seed=999,
                      patches=args.patches)
    _log(f"wrote {args.pairs} val pairs under {data_root}")

    with open(args.params, "rb") as fd:
        params = params_from_jax(pickle.load(fd))
    ckpt_src = osp.join(workdir, "ckpt_src")
    state = create_train_state(params, device="cpu")
    CheckpointIO(ckpt_src).save(state, epoch=1, min_loss=float("inf"),
                                is_best=False)
    _log(f"params converted to a checkpoint at {ckpt_src}")

    flagship = args.arch == "HPLFlowNet"
    ckpt_dir = osp.join(workdir, "ckpt_eval")
    cfg = {
        "ckpt_dir": ckpt_dir,
        "data_root": data_root,
        "resume": ckpt_src,
        "evaluate": True,
        "arch": args.arch,
        "dataset": "FlyingThings3DSubset",
        "full": True,
        "strict": False,
        "allow_less_points": True,
        "batch_size": 1,
        "num_points": args.num_points,
        "scales_filter_map": SFM7 if flagship else SFM5,
        "dim": 3,
        "data_process": {"DEPTH_THRESHOLD": 35.0, "NO_CORR": False},
        "compute_dtype": "bfloat16",
        "print_freq": 8,
        "workers": 2,
        "dump_visu": True,
    }
    if flagship and args.num_points == 8192:
        cfg["lattice_capacities"] = CAPACITIES
    if args.device is not None:
        cfg["platform"] = args.device
    metrics = driver.run(postprocess(Config(cfg)))
    out = {"arch": args.arch, "num_points": args.num_points,
           "pairs": args.pairs, "patches": args.patches,
           "params": args.params, **metrics,
           "visu_dir": osp.join(ckpt_dir, "visu_" + osp.basename(ckpt_dir))}
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w") as fd:
            fd.write(line + "\n")
    print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
