"""Gather strategies for the blur's hot path, at ``bcn1``'s table.

    python -m hplflownet_tpu_torch.tools.gather_lab [--reps 10] [--out f.json]

Port of ``tools/gather_experiments.py``.  On scale 0's 15-tap neighbour
table of one synthetic 8192-point pair, with a bf16 table of C_in 68 and
580 channels, it times three ways to gather and sum the taps:

* ``hmajor``: one (H, F, C) gather, summed over the taps;
* ``fmajor``: one (F, H, C) gather (each tap's indices are monotone);
* ``tapscan``: one (H, C) gather per tap, accumulated in a loop;

and the ``row_take`` kernel (csrc/row_take.cu, the port of the lab's
``pallas_take``) on a (H + 1, 128) bf16 table through one tap's indices,
checked against ``index_select`` bit for bit and timed beside it.  Prints
one JSON line with the times, the card's ``nvidia-smi`` line and the clock.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..kernels.take import row_take
from .microbench import pyramid
from .timing import (CAPACITIES, NUM_POINTS, card_line, clock_name,
                     print_result, time_ms)

__all__ = ["run", "main"]


def run(device=None, num_points: int = NUM_POINTS, capacities=CAPACITIES,
        reps: int = 10, warmup: int = 2, widths=(68, 580), seed: int = 0
        ) -> dict:
    dev = resolve_device(device)
    nb = pyramid(dev, num_points, capacities, seed)[0].pc1_blur_neighbors
    f, h = nb.shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ms: dict = {}

    def bench(name, fn):
        with torch.inference_mode():
            ms[name] = time_ms(fn, dev, reps, warmup)
        print(f"{name:48s} {ms[name]:9.4f} ms", file=sys.stderr, flush=True)

    def tapscan(t):
        acc = torch.zeros((h, t.shape[1]), dtype=t.dtype, device=dev)
        for k in range(f):
            acc = acc + t[(nb[k] + 1).long()]
        return acc

    hmajor_idx, fmajor_idx = (nb.t() + 1).long(), (nb + 1).long()
    for c_in in widths:
        table = torch.randn(h + 1, c_in, generator=gen, device=dev).to(torch.bfloat16)
        bench(f"gather hmajor ({h},{f},{c_in})",
              lambda t=table: t[hmajor_idx].sum(1))
        bench(f"gather fmajor ({f},{h},{c_in})",
              lambda t=table: t[fmajor_idx].sum(0))
        bench(f"gather tapscan ({f},{h},{c_in})", lambda t=table: tapscan(t))

    table = torch.randn(h + 1, 128, generator=gen, device=dev).to(torch.bfloat16)
    idx = (nb[3] + 1).contiguous()                      # (H,) monotone
    got = row_take(table, idx)
    want = table.index_select(0, idx.long())
    if not torch.equal(got, want):
        raise AssertionError("row_take differs from index_select")
    bench(f"row_take ({h + 1},128) bf16, one tap", lambda: row_take(table, idx))
    idx64 = idx.long()
    bench(f"index_select ({h + 1},128) bf16, one tap",
          lambda: table.index_select(0, idx64))
    return dict(tool="gather_lab", device=str(dev), card=card_line(dev),
                clock=clock_name(dev), reps=reps, points=num_points,
                take_shape=[h, 128], take_equal=True, ms=ms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for a toy run")
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--capacities", type=int, nargs=7, default=CAPACITIES)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--widths", type=int, nargs="*", default=(68, 580))
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.device, args.points, args.capacities, args.reps,
                 args.warmup, tuple(args.widths))
    print_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
