"""The lattice build's ``HPL_FUSED_BUILD`` modes against each other.

    python -m hplflownet_tpu_torch.tools.fused_build_bench [--modes 0,1,3584]
        [--arch HPLFlowNet] [--points 8192] [--reps 5] [--rounds 1]
        [--device cpu] [--capacities 1024,2048,...] [--out f.json]

For each value of ``HPL_FUSED_BUILD`` (``lattice.build``: "0" builds and
probes each cloud apart, "1" fuses both clouds at every scale, an integer
at the scales of at most that capacity) it times, on one synthetic pair at
full width in bf16 (``timing.model_case``):

* ``build_ms``: ``build_pyramid`` of the pair, the forward's tables;
* ``forward_ms``: ``pipeline.flow_forward``, build included;
* ``step_ms``: one train step (``train.step.make_train_step``, batch 1,
  Adam at lr 1e-4, overflow skip).

Each is the mean of ``--reps`` calls between CUDA events after a warm-up
call (the host clock on the CPU), and the modes take turns: the list,
then the list reversed (0, 1, 3584, 3584, 1, 0), ``--rounds`` times, so
that each mode's values bracket the others'.  Then, per mode, ``build_ops`` counts the torch
operators one ``build_pyramid`` of the pair dispatches (views excluded;
the forward's tables, and with the adjoint plans as a step builds them),
which the host pays for one by one, and ``torch.profiler`` counts the
device kernels per forward and per step (``profile_forward._trace``;
0 on the CPU, which runs no kernel), after the timings, since
tracing slows the host for the rest of the process.  The variable is
restored afterwards.
"""

from __future__ import annotations

import argparse
import contextlib
import os

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..device import resolve_device
from ..lattice import build_pyramid
from ..pipeline import flow_forward
from ..profile_forward import _trace
from ..train.step import make_train_step
from .timing import (ARCHS, NUM_POINTS, card_line, clock_name, model_case,
                     print_result, time_ms)

__all__ = ["fused_build", "run", "main"]

MODES = ("0", "1", "3584")
# aten operators that make a view and launch nothing
_VIEWS = frozenset({"view", "_unsafe_view", "slice", "select", "unsqueeze",
                    "squeeze", "reshape", "expand", "alias", "as_strided",
                    "t", "detach", "detach_", "lift_fresh"})


class _OpCount(TorchDispatchMode):
    """Counts the aten operators dispatched inside it, views excluded."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func._schema.name.split("::")[-1] not in _VIEWS:
            self.ops += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def fused_build(mode: str):
    """``HPL_FUSED_BUILD=mode`` inside, the caller's value restored after."""
    saved = os.environ.get("HPL_FUSED_BUILD")
    os.environ["HPL_FUSED_BUILD"] = mode
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("HPL_FUSED_BUILD", None)
        else:
            os.environ["HPL_FUSED_BUILD"] = saved


def run(device=None, modes=MODES, arch: str = "HPLFlowNet",
        num_points: int = NUM_POINTS, reps: int = 5, capacities=None,
        rounds: int = 1) -> dict:
    dev = resolve_device(device)
    model, spec, pc1, pc2 = model_case(arch, num_points, dev, capacities)
    ones = torch.ones((1, num_points), dtype=torch.bool, device=dev)
    batch = dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                 valid1=ones, valid2=ones)
    init, step = make_train_step(model, spec, learning_rate=1e-4,
                                 on_overflow="skip", device=dev)
    state = [init()]

    def build(adjoint_plans=False):
        with torch.inference_mode():
            build_pyramid(spec, pc1, pc2, adjoint_plans=adjoint_plans)

    def forward():
        flow_forward(model, spec, pc1, pc2, adjoint_plans=False)

    def train():
        state[0], _ = step(state[0], batch)

    calls = {"build_ms": build, "forward_ms": forward, "step_ms": train}
    ms = {k: {m: [] for m in modes} for k in calls}
    order = (list(modes) + list(reversed(modes))) * rounds
    for mode in order:
        with fused_build(mode):
            for k, fn in calls.items():
                ms[k][mode].append(time_ms(fn, dev, reps, warmup=1))
    cuda = dev.type == "cuda"
    launches = {"forward": {}, "step": {}}
    ops = {"forward": {}, "step": {}}
    for mode in modes:
        with fused_build(mode):
            for unit, adjoint_plans in (("forward", False), ("step", True)):
                with _OpCount() as count:
                    build(adjoint_plans)
                ops[unit][mode] = count.ops
            for unit, fn in (("forward", forward), ("step", train)):
                _, kernels = _trace(fn, 1, dev)
                launches[unit][mode] = (sum(c for _, c in kernels.values())
                                        if cuda else 0)
    return {"tool": "fused_build_bench", "arch": arch, "points": num_points,
            "capacities": [s.capacity for s in spec.scales],
            "modes": list(modes), "order": order, "reps": reps, **ms,
            "launches_forward": launches["forward"],
            "launches_step": launches["step"], "build_ops_forward": ops["forward"],
            "build_ops_step": ops["step"], "clock": clock_name(dev),
            "card": card_line(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--modes", default=",".join(MODES),
                    help="HPL_FUSED_BUILD values, comma-separated")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="HPLFlowNet")
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="times the modes take turns (each: the list, then reversed)")
    ap.add_argument("--capacities", default=None,
                    help="per-scale capacities, comma-separated (default: "
                    "the model's own at 8192 points, else measured)")
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    caps = (None if args.capacities is None
            else [int(c) for c in args.capacities.split(",")])
    res = run(args.device, tuple(args.modes.split(",")), args.arch,
              args.points, args.reps, caps, args.rounds)
    for k in ("build_ms", "forward_ms", "step_ms"):
        print(f"{k}: " + "; ".join(
            f"HPL_FUSED_BUILD={m} {[round(v, 3) for v in vals]}"
            for m, vals in res[k].items()))
    print(f"build_pyramid operators (forward's, step's) "
          f"{res['build_ops_forward']}, {res['build_ops_step']}; kernels per "
          f"forward {res['launches_forward']}, per step {res['launches_step']} "
          f"({res['card']})")
    print_result(res, args.out)
    return res


if __name__ == "__main__":
    main()
