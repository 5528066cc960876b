"""The flagship's constants and the one timer the port's tools use.

``SFM7``, ``CAPACITIES`` and ``NUM_POINTS`` are the JAX bench's flagship
(``bench.py:29-35``): the 7-scale map, its per-scale vertex capacities and
8192 points per cloud; ``SFM5`` and ``SHALLOW_CAPACITIES`` the shallow
model's (``tools/train_synthetic.py``'s map, capacities of
``lattice.capacity.measured_default_capacities(8192, SFM5)``).
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
           "time_ms", "graph_ms", "clock_name", "card_line", "print_result"]

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CAPACITIES = [25600, 31872, 12928, 3584, 896, 256, 128]
SFM5 = [[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1],
        [0.125, 1, 1, 1], [0.0625, 1, 1, 1]]
SHALLOW_CAPACITIES = [9472, 3712, 1024, 384, 128]
NUM_POINTS = 8192


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
