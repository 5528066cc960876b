"""The ``rank_partial`` kernel's blocks-per-CTA sweep, beside the splat
reductions the port runs.

    python -m hplflownet_tpu_torch.tools.rank_partial_lab [--reps 10]

Port of ``tools/rank_partial_lab.py``.  At the splat streams' sizes (M =
128000 and 102400 entries of 68 channels and R = 4 bf16 weight lanes, with
densities; block-sorted local ranks and random weight lanes from a seeded
generator) it times:

* ``rank_partial`` (csrc/rank_partial.cu, the port of the lab's
  ``variant``) at 8, 16 and 32 blocks of 128 entries per CTA, with float32
  and bf16 output, after checking it against its plain version;
* on the same stream, the reductions that stand where the partial stage
  stood: the default route's ``rank_reduce`` (partial and combine fused)
  and the fused route's ``blocked_rank_reduce``, each checked against its
  plain version.

Prints one JSON line with the times, the errors, the card's ``nvidia-smi``
line and the clock.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..kernels.rank_fused import blocked_rank_reduce, blocked_rank_reduce_plain
from ..kernels.rank_partial import rank_partial, rank_partial_plain
from ..kernels.splat import rank_reduce, rank_reduce_plain
from .timing import card_line, clock_name, print_result, time_ms

__all__ = ["run", "main", "lab_stream", "SIZES"]

SIZES = (128000, 102400)
BLOCK = 128


def lab_stream(m: int, c: int, r: int, gen, dev):
    """A sorted-stream stand-in: (g (M, C + R) bf16, rank_partial's meta,
    the global rank of each entry, and each entry's weight lane)."""
    g = torch.randn(m, c + r, generator=gen, device=dev).to(torch.bfloat16)
    nb = -(-m // BLOCK)
    lrank = torch.sort(torch.randint(0, BLOCK, (nb, BLOCK), generator=gen,
                                     device=dev), dim=1).values
    lrank = lrank.reshape(-1)[:m].to(torch.int32)
    lane = torch.randint(0, r, (m,), generator=gen, device=dev,
                         dtype=torch.int32)
    pos = torch.arange(m, device=dev)
    new = torch.ones(m, dtype=torch.bool, device=dev)
    new[1:] = lrank[1:] != lrank[:-1]
    new |= pos % BLOCK == 0
    grank = (torch.cumsum(new.to(torch.int32), 0, dtype=torch.int32) - 1)
    return g, (lrank | (lane << 16)).contiguous(), grank, lane


def _max_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max())


def run(device=None, sizes=SIZES, c: int = 68, r: int = 4, bos=(8, 16, 32),
        reps: int = 10, warmup: int = 2, seed: int = 0) -> dict:
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    ms: dict = {}
    errors: dict = {}

    def bench(name, fn):
        ms[name] = time_ms(fn, dev, reps, warmup)
        print(f"{name:48s} {ms[name]:9.4f} ms", file=sys.stderr, flush=True)

    for m in sizes:
        g, meta, grank, lane = lab_stream(m, c, r, gen, dev)
        for out_dt, tag in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            want = rank_partial_plain(g, meta, c, r, True, out_dt)
            errors[f"M={m} rank_partial {tag}-out"] = _max_err(
                rank_partial(g, meta, c, r, True, bo=bos[0], out_dtype=out_dt),
                want)
            for bo in bos:
                bench(f"M={m} rank_partial bo={bo} {tag}-out",
                      lambda bo=bo, dt=out_dt: rank_partial(
                          g, meta, c, r, True, bo=bo, out_dtype=dt))
        t = int(grank[-1]) + 1
        q = torch.arange(t, device=dev, dtype=torch.int32)
        start = torch.searchsorted(grank, q, side="left", out_int32=True)
        end = torch.searchsorted(grank, q, side="right", out_int32=True)
        errors[f"M={m} rank_reduce"] = _max_err(
            rank_reduce(g, lane, start, end, c, True),
            rank_reduce_plain(g, lane, start, end, c, True))
        bench(f"M={m} rank_reduce (T={t})",
              lambda: rank_reduce(g, lane, start, end, c, True))
        tp = -(-t // BLOCK) * BLOCK
        start_rows = torch.cat([start, start.new_full((tp - t,), m)])[::BLOCK]
        start_rows = start_rows.contiguous()
        meta5 = ((grank << 2) | lane).contiguous()
        errors[f"M={m} blocked_rank_reduce"] = _max_err(
            blocked_rank_reduce(g, meta5, start_rows, c, r, True),
            blocked_rank_reduce_plain(g, meta5, start_rows, c, r, True))
        bench(f"M={m} blocked_rank_reduce (T={t})",
              lambda: blocked_rank_reduce(g, meta5, start_rows, c, r, True))
    return dict(tool="rank_partial_lab", device=str(dev), card=card_line(dev),
                clock=clock_name(dev), reps=reps, sizes=list(sizes), c=c, r=r,
                max_abs_err=errors, ms=ms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for a toy run")
    ap.add_argument("--sizes", type=int, nargs="*", default=SIZES)
    ap.add_argument("--bos", type=int, nargs="*", default=(8, 16, 32))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.device, tuple(args.sizes), bos=tuple(args.bos),
                 reps=args.reps, warmup=args.warmup)
    print_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
