"""Vertex counts of a traffic mix's pairs, per scale, on the CPU.

    python -m flowbench.tools.capacities --mix eval-98k --config flagship \
        --seeds 64 [--pairs 8] [--workers 4] [--check 25600,31872,...]

Builds every cloud of the first ``--pairs`` pool pairs of seeds
0..``--seeds``-1 with the reference lattice (no capacity limit) and prints
per scale the largest count, the suggested capacity (largest x 1.25,
aligned to 128) and, with ``--check``, the pairs that would overflow the
given capacities.  Vertex counts are integer work: the card's build meets
the same ones.
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
    """Distinct vertices per scale of one cloud, the chain uncapped."""
    pts = torch.from_numpy(points)
    n = pts.shape[0]
    elev, valid = elevate(pts, scales[0]), torch.ones(n, dtype=torch.bool)
    counts = []
    for i, s in enumerate(scales):
        cap = elev.shape[0] * (elev.shape[1])
        c = _cloud(elev, valid, cap)
        if c.overflow:
            raise RuntimeError(f"points out of the key range at scale {s}")
        counts.append(c.num_valid)
        if i + 1 < len(scales):
            ratio = np.float32(scales[i + 1]) / np.float32(s)
            elev = c.coords[:c.num_valid].to(torch.float32) * torch.tensor(ratio)
            valid = torch.ones(c.num_valid, dtype=torch.bool)
    return counts


def _job(args):
    mix, scales, seed, k = args
    torch.set_num_threads(1)
    pc1, pc2 = frustum_pair(_pair_rng(seed, k), mix)
    return seed, k, [max(a, b) for a, b in zip(cloud_counts(pc1, scales),
                                                 cloud_counts(pc2, scales))]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mix", required=True)
    ap.add_argument("--config", required=True)
    ap.add_argument("--seeds", type=int, default=64)
    ap.add_argument("--pairs", type=int, default=None,
                    help="pairs per seed (default: the whole pool)")
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--check", default=None,
                    help="comma-separated capacities to test")
    args = ap.parse_args(argv)
    mix, cfg = load_mix(args.mix), load_config(args.config)
    scales = [row[0] for row in cfg["scales_filter_map"]]
    pairs = args.pairs or int(mix["pool"])
    jobs = [(mix, scales, s, k) for s in range(args.seeds) for k in range(pairs)]
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(args.workers) as pool:
        rows = pool.map(_job, jobs)
    worst = np.max([r[2] for r in rows], axis=0)
    result = {"mix": args.mix, "config": args.config, "seeds": args.seeds,
              "pairs_per_seed": pairs, "max_counts": worst.tolist(),
              "capacity_x1.25": [int(-(-int(w * 1.25) // 128) * 128) for w in worst]}
    if args.check:
        caps = [int(c) for c in args.check.split(",")]
        over = [(s, k, c) for s, k, c in rows
                if any(x > cap for x, cap in zip(c, caps))]
        result["checked"] = caps
        result["overflowing_pairs"] = len(over)
        result["examples"] = over[:5]
        result["headroom"] = [round(cap / w - 1, 4) for cap, w in zip(caps, worst)]
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    sys.exit(0 if main() else 1)
