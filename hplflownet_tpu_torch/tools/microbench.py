"""Op-level microbenchmarks of the flagship at its real shapes.

    python -m hplflownet_tpu_torch.tools.microbench [--reps 10] [--out f.json]
    python -m hplflownet_tpu_torch.tools.microbench --device cpu --points 128 \
        --capacities 1024 2048 2048 1024 512 256 128 --width-div 8 --reps 1

Port of ``tools/microbench.py``.  On a real pyramid of one synthetic
8192-point pair (the 7-scale map, the flagship capacities), with bf16 data
from a seeded generator, it times:

* the five blur shapes of the encoder and decoder (``ops.bcl.blur``:
  the ``stencil_gather_matmul`` kernel, float32 output, the table's stencil
  plan made beforehand, as the model does once per pair);
* two speed-of-light GEMMs of the blur's shape (``torch.matmul`` in bf16);
* ``gather15``: the blur's 15-tap row gather and a sum, at 68 and 580
  channels;
* at scale 2: ``corr_cross``, ``corr_self``, ``corr_gather1`` (the
  15-tap ``gather_rows``) and its adjoint (``apply_reduce_plan``, the
  ``rank_reduce`` kernel's plain-row mode);
* at scale 0: the splat (``rank_reduce``) and the 1024-channel slice in
  float32 and bf16;
* the lattice builder's sorts (stable int64 keys, and int32 keys) at the
  probe sizes.

Each op is timed with CUDA events over ``--reps`` calls after a warm-up
(``tools.timing``).  Prints one JSON line: the times in ms, the card's
``nvidia-smi`` name and power limit, and the clock.  ``--width-div``
divides every channel width, for toy runs on the CPU.
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..device import resolve_device
from ..kernels.stencil_plan import make_stencil_plan
from ..lattice import build_pyramid
from ..lattice.capacity import synthetic_frustum_clouds
from ..ops import bcl, corr, segment
from ..pipeline import make_lattice_spec
from .timing import (CAPACITIES, NUM_POINTS, SFM7, card_line, clock_name,
                     print_result, time_ms)

__all__ = ["run", "main", "SORT_SIZES"]

SORT_SIZES = (131072, 425984, 880000)
# (name, scale, C_in, C_out): the encoder's 68 -> 64 blurs and the decoder's
BLURS = (("blur_down_s0", 0, 68, 64), ("blur_down_s1", 1, 68, 64),
         ("blur_up_s0", 0, 580, 1024), ("blur_up_s1", 1, 324, 512),
         ("blur_up_s2", 2, 388, 256))


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def pyramid(device, num_points=NUM_POINTS, capacities=CAPACITIES, seed=0):
    """The lattice pyramid of one synthetic pair on ``device``."""
    pc1, pc2 = synthetic_frustum_clouds(1, num_points, seed=seed)
    spec = make_lattice_spec(SFM7, capacities)
    with torch.inference_mode():
        return build_pyramid(spec, torch.from_numpy(pc1[0]).to(device),
                             torch.from_numpy(pc2[0]).to(device),
                             adjoint_plans=False)


def run(device=None, num_points: int = NUM_POINTS, capacities=CAPACITIES,
        reps: int = 10, warmup: int = 2, width_div: int = 1,
        sort_sizes=SORT_SIZES, seed: int = 0) -> dict:
    dev = resolve_device(device)
    scales = pyramid(dev, num_points, capacities, seed)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    bf = torch.bfloat16
    ms: dict = {}

    def width(c):
        return max(1, c // width_div)

    def randn(*shape, dtype=bf):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def bench(name, fn):
        with torch.inference_mode():
            ms[name] = time_ms(fn, dev, reps, warmup)
        _log(f"{name:48s} {ms[name]:9.4f} ms")

    for name, si, c_in, c_out in BLURS:
        c_in, c_out = width(c_in), width(c_out)
        nb = scales[si].pc1_blur_neighbors
        h = nb.shape[1]
        table, kern = randn(h + 1, c_in), randn(15, c_in, c_out)
        bias = torch.zeros(c_out, device=dev)
        plan = make_stencil_plan(nb, h, lists=False)   # made once per pair
        bench(f"{name} ({h},{c_in}->{c_out})",
              lambda t=table, n=nb, k=kern, b=bias, p=plan: bcl.blur(
                  t, n, k, b, None, torch.float32, plan=p))

    h0 = scales[0].pc1_blur_neighbors.shape[1]
    for c_in, c_out in ((68, 64), (580, 1024)):
        fc_in, c_out = 15 * width(c_in), width(c_out)
        x, w = randn(h0, fc_in), randn(fc_in, c_out)
        bench(f"matmul ({h0},{fc_in})@({fc_in},{c_out})",
              lambda x=x, w=w: torch.matmul(x, w))

    nb0 = scales[0].pc1_blur_neighbors
    for c_in in (68, 580):
        c_in = width(c_in)
        table = randn(h0 + 1, c_in)
        bench(f"gather15 ({h0},{c_in})",
              lambda t=table: t[(nb0.t() + 1).long()].reshape(h0, -1).sum(1))

    sp2 = scales[2]
    h2 = sp2.pc1_corr_indices.shape[-1]
    c2, w2 = width(64), width(32)
    pad2 = randn(h2 + 1, c2)
    n_uniq = sp2.pc2_corr_uniq.shape[0]
    k2 = randn(n_uniq, c2, 15, w2)
    cross_plan = make_stencil_plan(sp2.pc2_corr_uniq, h2, lists=False)
    bench(f"corr_cross_s2 ({n_uniq},{h2},{c2} uniq)",
          lambda: corr.corr_cross(pad2, sp2.pc2_corr_uniq, k2, plan=cross_plan))
    k_self = randn(15, c2, w2)
    zero_bias = torch.zeros(w2, device=dev)
    self_plan = make_stencil_plan(sp2.pc1_corr_indices, h2, lists=False)
    bench(f"corr_self_s2 (15,{h2},{c2}->{w2})",
          lambda: corr.corr_self(pad2, sp2.pc1_corr_indices, k_self, zero_bias,
                                 plan=self_plan))
    bench(f"corr_gather1_s2 (15,{h2},{c2})",
          lambda: corr.gather_rows(pad2, sp2.pc1_corr_indices).sum(0))
    plan = segment.make_reduce_plan(sp2.pc1_corr_indices, h2)
    cot = randn(sp2.pc1_corr_indices.numel(), c2)
    bench(f"corr_gather1_adjoint_s2 (15*{h2},{c2} -> {h2})",
          lambda: segment.apply_reduce_plan(plan, cot))

    sp0 = scales[0]
    n = sp0.pc1_barycentric.shape[0]
    feats = randn(n, width(68), dtype=torch.float32)
    bench(f"splat_s0 ({n}x4 -> {h0}, {width(68)}ch)",
          lambda: bcl.splat(feats, sp0.pc1_barycentric, sp0.pc1_splat_plan))
    for dt, tag in ((torch.float32, "f32"), (bf, "bf16")):
        blurred = randn(h0, width(1024), dtype=dt)
        bench(f"slice_s0 ({h0} -> {n}, {width(1024)}ch {tag})",
              lambda b=blurred: bcl.slice_to_points(
                  b, sp0.pc1_barycentric, sp0.pc1_lattice_offset))

    for m in sort_sizes:
        k64 = torch.randint(-2**62, 2**62, (m,), generator=gen, device=dev)
        k32 = torch.randint(-3000, 3000, (m,), generator=gen, device=dev,
                            dtype=torch.int32)
        bench(f"sort64_stable x{m}", lambda k=k64: torch.sort(k, stable=True))
        bench(f"sort32 x{m}", lambda k=k32: torch.sort(k))

    return dict(tool="microbench", device=str(dev), card=card_line(dev),
                clock=clock_name(dev), reps=reps, points=num_points,
                capacities=list(capacities), width_div=width_div, ms=ms)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu for a toy run")
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--capacities", type=int, nargs=7, default=CAPACITIES)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=2)
    ap.add_argument("--width-div", type=int, default=1)
    ap.add_argument("--sort-sizes", type=int, nargs="*", default=SORT_SIZES)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.device, args.points, args.capacities, args.reps,
                 args.warmup, args.width_div, tuple(args.sort_sizes))
    print_result(result, args.out)
    return result


if __name__ == "__main__":
    main()
