"""Vertex counts of a one-cloud mix's clouds, per scale, on the CPU.

    python -m flowbench.tools.cloud_capacities --mix seg-98k --config splatnet3d \
        --seeds 64 [--clouds 8] [--workers 3] [--points 128]

For the first ``--clouds`` pool items of seeds 0..``--seeds``-1, the first
cloud of ``generator.py``'s pair (what a one-cloud mix's pool holds) is
built at every scale of the configuration, each scale elevated from the
points themselves (SPLATNet3D's lattices, not a pyramid), with the
reference lattice and no capacity limit.  Prints per scale the largest
count and the suggested capacity (largest x 1.25, aligned to 128), as
``capacities.py`` does for pairs; ``--points`` overrides the mix's point
count (128: the CPU rehearsal's).
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys

import numpy as np
import torch

from ..configs import load_config
from ..reference.lattice import _cloud, elevate
from ..traffic.generator import _pair_rng, frustum_pair, load_mix


def cloud_counts(points: np.ndarray, scales) -> list:
    """Distinct vertices of one cloud at each scale, uncapped."""
    pts = torch.from_numpy(points)
    n = pts.shape[0]
    valid = torch.ones(n, dtype=torch.bool)
    counts = []
    for s in scales:
        c = _cloud(elevate(pts, s), valid, n * (pts.shape[1] + 1))
        if c.overflow:
            raise RuntimeError(f"points out of the key range at scale {s}")
        counts.append(c.num_valid)
    return counts


def _job(args):
    mix, scales, seed, k = args
    torch.set_num_threads(1)
    pc1, _ = frustum_pair(_pair_rng(seed, k), mix)
    return seed, k, cloud_counts(pc1, scales)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mix", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--clouds", type=int, default=None,
                    help="clouds per seed (default: the whole pool)")
    ap.add_argument("--points", type=int, default=None)
    ap.add_argument("--workers", type=int, default=3)
    args = ap.parse_args(argv)
    mix, cfg = load_mix(args.mix), load_config(args.config)
    if args.points:
        mix = dict(mix, num_points=args.points)
    scales = [float(row[0]) for row in cfg["scales_filter_map"]]
    clouds = args.clouds or int(mix["pool"])
    jobs = [(mix, scales, s, k) for s in range(args.seeds) for k in range(clouds)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        rows = pool.map(_job, jobs)
    worst = np.max([r[2] for r in rows], axis=0)
    result = {"mix": args.mix, "config": args.config, "points": int(mix["num_points"]),
              "seeds": args.seeds, "clouds_per_seed": clouds,
              "max_counts": worst.tolist(),
              "capacity_x1.25": [int(-(-int(w * 1.25) // 128) * 128) for w in worst]}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
