"""The flagship's constants and the one timer the port's tools use.

``SFM7``, ``CAPACITIES`` and ``NUM_POINTS`` are the JAX bench's flagship
(``bench.py:29-35``): the 7-scale map, its per-scale vertex capacities and
8192 points per cloud; ``SFM5`` and ``SHALLOW_CAPACITIES`` the shallow
model's (``tools/train_synthetic.py``'s map, capacities of
``lattice.capacity.measured_default_capacities(8192, SFM5)``), and
:func:`pair_case` and :func:`model_case` make one synthetic pair and
either model at full width.
:func:`time_ms` times a call with CUDA events on
the card (warm-up calls first, then the mean over ``reps`` calls), or with
the host clock on the CPU, whose numbers are no device metric.
:func:`graph_ms` times one call's device work alone: a CUDA graph of many
captured calls, replayed, so the wrapper's host time drops out.
"""

from __future__ import annotations

import json
import subprocess
import time

import torch

__all__ = ["SFM7", "CAPACITIES", "SFM5", "SHALLOW_CAPACITIES", "NUM_POINTS",
           "ARCHS", "pair_case", "model_case", "time_ms", "graph_ms", "clock_name",
           "card_line", "print_result"]

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CAPACITIES = [25600, 31872, 12928, 3584, 896, 256, 128]
SFM5 = [[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1],
        [0.125, 1, 1, 1], [0.0625, 1, 1, 1]]
SHALLOW_CAPACITIES = [9472, 3712, 1024, 384, 128]
NUM_POINTS = 8192
# each model's map and its capacities at NUM_POINTS
ARCHS = {"HPLFlowNet": (SFM7, CAPACITIES),
         "HPLFlowNetShallow": (SFM5, SHALLOW_CAPACITIES)}


def pair_case(arch: str = "HPLFlowNet", num_points: int = NUM_POINTS,
              device=None, capacities=None, cloud_seed: int = 0):
    """-> (spec, pc1, pc2): ``arch``'s lattice spec and one synthetic
    FT3D-like pair of ``num_points`` (``synthetic_frustum_clouds``,
    ``cloud_seed``) as (N, 3) float32 tensors on ``device`` (the card by
    default).  Capacities: ``capacities``, else the model's own at
    NUM_POINTS, else ``measured_default_capacities`` at ``num_points``."""
    from ..device import resolve_device
    from ..lattice.capacity import (measured_default_capacities,
                                    synthetic_frustum_clouds)
    from ..pipeline import make_lattice_spec
    sfm, default = ARCHS[arch]
    if capacities is None:
        capacities = (default if num_points == NUM_POINTS
                      else measured_default_capacities(num_points, sfm))
    dev = resolve_device(device)
    pc1, pc2 = synthetic_frustum_clouds(1, num_points, seed=cloud_seed)
    return (make_lattice_spec(sfm, list(capacities)),
            torch.from_numpy(pc1[0]).to(dev), torch.from_numpy(pc2[0]).to(dev))


def model_case(arch: str = "HPLFlowNet", num_points: int = NUM_POINTS,
               device=None, capacities=None, seed: int = 0,
               cloud_seed: int = 0):
    """-> (model, spec, pc1, pc2): :func:`pair_case` and ``arch`` at full
    width in bfloat16 with weights seeded by ``seed``
    (``params.seeded_jax_params``) on the same device."""
    from ..models import MODELS
    from ..params import params_from_jax, seeded_jax_params
    spec, pc1, pc2 = pair_case(arch, num_points, device, capacities, cloud_seed)
    model = MODELS[arch](ARCHS[arch][0], compute_dtype="bfloat16",
                          device=pc1.device)
    params_from_jax(seeded_jax_params(model, seed), model)
    return model, spec, pc1, pc2


def time_ms(fn, device, reps: int = 10, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``reps`` calls after ``warmup`` calls.

    On a CUDA device: CUDA events around the ``reps`` calls, then a
    synchronise, so the time is the device's.  On the CPU: the host clock.
    """
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, device, calls: int = 20, replays: int = 5) -> float:
    """Mean device ms of one ``fn()`` call: CUDA events around ``replays``
    replays of a CUDA graph of ``calls`` captured calls (one warm-up call
    first, off the capture).  On the CPU: :func:`time_ms` over 2 calls."""
    if torch.device(device).type != "cuda":
        return time_ms(fn, device, reps=2, warmup=1)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / (replays * calls)


def clock_name(device) -> str:
    return "cuda events" if torch.device(device).type == "cuda" else "host clock"


def card_line(device=None) -> str:
    """The card's name and power limit as ``nvidia-smi --query-gpu=name,
    power.limit --format=csv,noheader`` gives them, or what ran instead."""
    if device is not None and torch.device(device).type != "cuda":
        return "cpu (host clock; no device number)"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not available"
    return out.splitlines()[0].strip() if out else "nvidia-smi not available"


def print_result(result: dict, out: str | None = None) -> None:
    """Print a tool's result as one JSON line, and write it to ``out``."""
    line = json.dumps(result)
    if out:
        with open(out, "w") as fd:
            fd.write(line + "\n")
    print(line, flush=True)
