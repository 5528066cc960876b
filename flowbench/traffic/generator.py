"""The traffic generator of FT3D-like pairs: a mix file's parameters and a
seed -> requests.

A mix is ``flowbench/traffic/<name>.json``.  Its keys:

* ``entry``: which entry of the program the requests drive
  (``flowbench/entries/<entry>.py``);
* ``generator`` (optional): the module of ``flowbench/traffic/`` that
  makes the mix's pool and request order (``make_pool(mix, seed)``,
  ``request_order(mix, seed)``); without it, this one.  Every mix has
  ``num_points``, ``pool`` and ``check``: the rehearsal cuts them;
* ``num_points``: points per cloud;
* ``pool``: distinct pairs made per run; requests cycle through the pool,
  in a fresh order drawn from the seed on every pass;
* ``patches``, ``center_low``, ``center_high``, ``spread``, ``flow_scale``,
  ``noise``: the FlyingThings3D-like scene (points on planar patches whose
  centres are uniform in a frustum box, each patch moved by one flow);
* ``check``: how many requests the correctness check takes (``requests``),
  and for training, how many first steps the reference follows (``steps``).

Pair k of a run with seed s is drawn from its own generator, seeded by
``SeedSequence([s, k])``, so every seed gives the same sizes and the same
work per request, and any whole number is a seed.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

__all__ = ["MIX_DIR", "load_mix", "frustum_pair", "Pool", "make_pool",
           "request_order"]

MIX_DIR = Path(__file__).resolve().parent


def load_mix(name: str) -> dict:
    with open(MIX_DIR / f"{name}.json") as fd:
        return json.load(fd)


def _pair_rng(seed: int, k: int) -> np.random.RandomState:
    state = np.random.SeedSequence([int(seed) % (1 << 64), k]).generate_state(1)
    return np.random.RandomState(int(state[0]))


def frustum_pair(rng: np.random.RandomState, mix: dict):
    """(pc1, pc2) float32 (N, 3): points on ``patches`` planar patches,
    pc2 = pc1 moved by its patch's flow plus noise (the program's
    ``lattice.capacity.synthetic_frustum_clouds``, with the numbers of its
    scene as parameters)."""
    n, patches = int(mix["num_points"]), int(mix["patches"])
    lo, hi = mix["center_low"], mix["center_high"]
    centers = np.stack([rng.uniform(lo[i], hi[i], patches) for i in range(3)],
                       axis=1).astype(np.float32)
    which = rng.randint(0, patches, n)
    local = rng.randn(n, 3).astype(np.float32)
    normals = rng.randn(patches, 3).astype(np.float32)
    normals /= np.linalg.norm(normals, axis=1, keepdims=True)
    local -= (local * normals[which]).sum(1, keepdims=True) * normals[which]
    pc1 = centers[which] + np.float32(mix["spread"]) * local
    flow = np.float32(mix["flow_scale"]) * rng.randn(patches, 3).astype(np.float32)
    pc2 = pc1 + flow[which] + np.float32(mix["noise"]) * rng.randn(n, 3).astype(
        np.float32)
    return pc1.astype(np.float32), pc2.astype(np.float32)


class Pool(NamedTuple):
    pc1: list            # pool of (N, 3) float32 host arrays
    pc2: list
    sf: list             # ground-truth flow pc2 - pc1


def make_pool(mix: dict, seed: int) -> Pool:
    pc1, pc2 = zip(*(frustum_pair(_pair_rng(seed, k), mix)
                     for k in range(int(mix["pool"]))))
    return Pool(list(pc1), list(pc2), [b - a for a, b in zip(pc1, pc2)])


def request_order(mix: dict, seed: int):
    """An endless iterator of pool indices: each pass a new permutation."""
    p = int(mix["pool"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), p, 1]))
    while True:
        yield from (int(k) for k in rng.permutation(p))
