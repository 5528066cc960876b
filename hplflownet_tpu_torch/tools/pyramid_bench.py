"""The lattice build split into its stages, per scale.

    python -m hplflownet_tpu_torch.tools.pyramid_bench [--points 8192]
        [--arch HPLFlowNet] [--reps 8] [--device cpu] [--out f.json]

Port of ``tools/pyramid_bench.py``.  Builds both clouds of one synthetic
FT3D-like pair down the pyramid and times, at every scale, the three
stages of ``lattice.build``:

* ``build``: ``_build_from_elevated`` (elevation keys, sort, dedup, the
  splat plan), one cloud;
* ``nbtable``: ``_neighbor_table``, the blur probes of one cloud;
* ``corr``: ``_corr_tables`` between the clouds (the forward's tables)
  and ``corr_inv`` (with the backward's inverse map, as a train step
  builds them);

beside the whole ``build_pyramid`` of the pair.  Each time is the mean of
``--reps`` calls between CUDA events after a warm-up call (the host clock
on the CPU).  At 8192 points the model's own capacities are used, at other
sizes ``measured_default_capacities``.  (The JAX tool's scan-carry protocol
worked around the TPU's compiler and is not carried over.)
"""

from __future__ import annotations

import argparse

import torch

from ..device import resolve_device
from ..lattice import build_pyramid
from ..lattice.build import (_build_from_elevated, _corr_tables,
                             _neighbor_table, _next_elevated)
from ..lattice.geometry import elevate
from ..lattice.offsets import neighborhood_offsets
from .timing import (ARCHS, NUM_POINTS, card_line, clock_name, pair_case,
                     print_result, time_ms)

__all__ = ["run", "main"]


def run(device=None, num_points: int = NUM_POINTS, arch: str = "HPLFlowNet",
        reps: int = 8, warmup: int = 1, capacities=None) -> dict:
    dev = resolve_device(device)
    spec, pc1, pc2 = pair_case(arch, num_points, dev, capacities)
    d, ms = spec.d, {}

    def timed(name, fn):
        ms[name] = time_ms(fn, dev, reps, warmup)
        return fn()

    with torch.inference_mode():
        ones = torch.ones(num_points, dtype=torch.bool, device=dev)
        elev = [(elevate(p, spec.scales[0].scale), ones) for p in (pc1, pc2)]
        for i, ss in enumerate(spec.scales):
            cl1 = timed(f"build_s{i}", lambda: _build_from_elevated(
                *elev[0], ss.capacity))
            cl2 = _build_from_elevated(*elev[1], ss.capacity)
            nb1 = None
            if ss.blur_radius != -1:
                offs = neighborhood_offsets(ss.blur_radius, d)
                nb1 = timed(f"nbtable_s{i}", lambda: _neighbor_table(cl1, offs, d))
            if ss.corr_filter_radius != -1:
                f_offs = neighborhood_offsets(ss.corr_filter_radius, d)
                c_offs = neighborhood_offsets(ss.corr_corr_radius, d)
                reuse = nb1 if ss.corr_corr_radius == ss.blur_radius else None
                for name, inv in ((f"corr_s{i}", False), (f"corr_inv_s{i}", True)):
                    timed(name, lambda: _corr_tables(cl1, cl2, f_offs, c_offs, d,
                                                     pc1_corr=reuse,
                                                     with_inverse=inv))
            if i + 1 < len(spec.scales):
                nxt = spec.scales[i + 1].scale
                elev = [_next_elevated(cl, d, ss.scale, nxt) for cl in (cl1, cl2)]
        ms["build_pyramid"] = time_ms(
            lambda: build_pyramid(spec, pc1, pc2, adjoint_plans=False), dev,
            reps, warmup)
    stages = {s: sum(v for k, v in ms.items() if k.startswith(s + "_s"))
              for s in ("build", "nbtable", "corr", "corr_inv")}
    return {"tool": "pyramid_bench", "points": num_points, "arch": arch,
            "capacities": [s.capacity for s in spec.scales], "reps": reps,
            "ms": ms, "stage_ms": stages, "clock": clock_name(dev),
            "card": card_line(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--arch", choices=sorted(ARCHS), default="HPLFlowNet")
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.device, args.points, args.arch, args.reps)
    print_result(res, args.out)
    return res


if __name__ == "__main__":
    main()
