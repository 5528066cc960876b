"""The top kernels of one forward (or train step) by self device time.

    python -m hplflownet_tpu_torch.tools.op_profile [--train] [--top 30]
        [--arch HPLFlowNet] [--points 8192] [--reps 4] [--device cpu]
        [--out f.json]

Port of ``tools/op_profile.py``, rebuilt on ``torch.profiler``
(``profile_forward._trace``): ``--reps`` flagship forwards
(``pipeline.flow_forward``, bf16, ``adjoint_plans=False``) or train steps
(``--train``: ``train.step.make_train_step``, batch 1, Adam at lr 1e-4)
after a warm-up call are traced, and every CUDA kernel's self device time
and launches are divided by the number of calls.  It prints the ``--top``
kernels with their share of the device busy time, then the same rolled up
into families (the kernel's name without template arguments) and into
``profile_forward``'s groups.  On the CPU (``--device cpu``) the entries
are the ATen operators' self host times: no device number.
"""

from __future__ import annotations

import argparse
import re

import torch

from ..device import resolve_device
from ..pipeline import flow_forward
from ..profile_forward import _group, _trace
from ..train.step import make_train_step
from .timing import ARCHS, NUM_POINTS, card_line, model_case, print_result

__all__ = ["family", "run", "main"]


def family(name: str) -> str:
    """A kernel's family: its name without the return type, template
    arguments, parameter list or a trailing numeric suffix."""
    base = name.split("<", 1)[0]
    base = re.sub(r"\(.*\)\s*$", "", base)
    base = re.sub(r"^void\s+", "", base).strip()
    return re.sub(r"[._\d]+$", "", base) or name


def run(device=None, train: bool = False, arch: str = "HPLFlowNet",
        num_points: int = NUM_POINTS, reps: int = 4, top: int = 30) -> dict:
    dev = resolve_device(device)
    model, spec, pc1, pc2 = model_case(arch, num_points, dev)
    if train:
        ones = torch.ones((1, num_points), dtype=torch.bool, device=dev)
        batch = dict(pc1=pc1[None], pc2=pc2[None], sf=(pc2 - pc1)[None],
                     valid1=ones, valid2=ones)
        init, step = make_train_step(model, spec, learning_rate=1e-4,
                                     on_overflow="skip", device=dev)
        state = [init()]

        def call():
            state[0], _ = step(state[0], batch)
    else:
        def call():
            flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    call()
    wall_ms, kernels = _trace(call, reps, dev)
    busy = sum(ms for ms, _ in kernels.values())
    unit = "step" if train else "pair"
    rows = sorted(kernels.items(), key=lambda kv: -kv[1][0])
    families: dict = {}
    groups: dict = {}
    for name, (ms, cnt) in rows:
        for table, key in ((families, family(name)), (groups, _group(name))):
            acc = table.setdefault(key, [0.0, 0.0])
            acc[0] += ms
            acc[1] += cnt

    def table(items, n):
        return [{"name": k, "ms": v[0], "launches": v[1],
                 "share": v[0] / busy if busy else 0.0}
                for k, v in sorted(items, key=lambda kv: -kv[1][0])[:n]]

    cuda = dev.type == "cuda"
    return {"tool": "op_profile", "what": "train step" if train else "forward",
            "arch": arch, "points": num_points, "calls": reps,
            "clock": ("torch.profiler device time" if cuda
                      else "torch.profiler host time of CPU operators"),
            "wall_ms_per_" + unit: wall_ms, "busy_ms_per_" + unit: busy,
            "kernels_per_" + unit: sum(c for _, c in kernels.values()),
            "top": table([(k, list(v)) for k, v in rows], top),
            "families": table(families.items(), top),
            "groups": table(groups.items(), len(groups)),
            "card": card_line(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="HPLFlowNet")
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.device, args.train, args.arch, args.points, args.reps,
              args.top)
    unit = "step" if args.train else "pair"
    print(f"{res['what']}: {res['wall_ms_per_' + unit]:.3f} ms wall, "
          f"{res['busy_ms_per_' + unit]:.3f} ms busy, "
          f"{res['kernels_per_' + unit]:.0f} kernels per {unit} ({res['clock']})")
    for title, key in (("kernels", "top"), ("families", "families"),
                       ("groups", "groups")):
        print(f"-- {title} --")
        for r in res[key]:
            print(f"{r['ms']:9.4f} ms {100 * r['share']:5.1f}% "
                  f"{r['launches']:7.1f}x  {r['name'][:100]}")
    print_result(res, args.out)
    return res


if __name__ == "__main__":
    main()
