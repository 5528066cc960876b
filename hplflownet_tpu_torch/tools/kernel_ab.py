"""Kernels 2 and 4 of this tree against another tree's, on one card.

    python -m hplflownet_tpu_torch.tools.kernel_ab --other DIR [--out f.json]

``DIR`` holds another version of the package (for example the parent
commit unpacked with ``git archive``); its ``hplflownet_tpu_torch/csrc/
rank_reduce.cu`` and ``stencil_tap_tables_sum.cu`` are built with the same
``nvcc`` flags and called through the same C interface.  Both versions run
on the inputs one flagship train step gives the two kernels (recorded by
``tools.step_calls``, every distinct shape, bf16 and a float32 copy), on the
``gather_rows`` adjoint's plain rows (R = 0) of ``chip_smoke.py`` phase 3,
and on the edge cases of ``tools.rank_cases`` and ``tools.tap_cases``.
For each input it checks that both versions give the same bits (both sum
every output in the same order) and times both with a replayed CUDA graph
(``timing.graph_ms``) in turns: other, this, this, other.  Prints one line
per input and one JSON object last.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

from .timing import CAPACITIES, NUM_POINTS, card_line, graph_ms, print_result

__all__ = ["build_other", "run", "main"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIGS = {"rank_reduce": ("hpl_rank_reduce", "piiipppiipip"),
         "stencil_tap_tables_sum": ("hpl_stencil_tap_tables_sum", "piipiipip")}


def build_other(root) -> dict:
    """Build the two kernels of the package under ``root`` -> {name: the C
    entry point}."""
    from ..kernels import _build
    csrc = Path(root) / "hplflownet_tpu_torch" / "csrc"
    out_dir = _build.BUILD_DIR / "other"
    out_dir.mkdir(parents=True, exist_ok=True)
    fns = {}
    for name, (symbol, sig) in _SIGS.items():
        src = csrc / f"{name}.cu"
        h = hashlib.sha256(src.read_bytes())
        for header in sorted(csrc.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(_build._FLAGS).encode())
        lib = out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"
        if not lib.exists():
            subprocess.run([_build.find_nvcc(), *_build._FLAGS, "-o", str(lib),
                            str(src)], check=True, capture_output=True)
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = [_build._CTYPES[a] for a in sig]
        fns[name] = fn
    return fns


def _other_reduce(fn, g, rid, start, end, c, with_w):
    out = torch.empty((start.shape[0], c + int(with_w)), dtype=torch.float32,
                      device=g.device)
    rc = fn(g.data_ptr(), g.shape[0], g.shape[1], c,
            None if rid is None else rid.data_ptr(), start.data_ptr(),
            end.data_ptr(), start.shape[0], int(with_w), out.data_ptr(),
            _DTYPES[g.dtype], torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other rank_reduce: CUDA error {rc}")
    return out


def _other_taps(fn, tables, c, nb):
    out = torch.empty((nb.shape[1], c), dtype=torch.float32, device=tables.device)
    rc = fn(tables.data_ptr(), tables.shape[0], c, nb.data_ptr(), nb.shape[0],
            nb.shape[1], out.data_ptr(), _DTYPES[tables.dtype],
            torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"other stencil_tap_tables_sum: CUDA error {rc}")
    return out


def _inputs(dev, num_points, capacities):
    """(kernel, case, dtype, launches per step, this(), other(fn)) for every
    input: the train step's shapes in bf16 and float32, the plain rows, the
    edge cases."""
    from ..kernels.splat import rank_reduce
    from ..kernels.tap_tables import stencil_tap_tables_sum
    from ..lattice import build_pyramid
    from ..lattice.capacity import synthetic_frustum_clouds
    from ..ops.segment import make_reduce_plan
    from ..pipeline import make_lattice_spec
    from .rank_cases import reduce_cases, to_torch
    from .step_calls import flagship_calls
    from .tap_cases import tap_cases
    from .timing import SFM7
    out = []

    def reduce_case(name, launches, g, rid, start, end, c, with_w):
        dt = str(g.dtype).replace("torch.", "")
        out.append(("rank_reduce", name, dt, launches,
                    lambda: rank_reduce(g, rid, start, end, c, with_w),
                    lambda fn: _other_reduce(fn, g, rid, start, end, c, with_w)))

    def tap_case(name, launches, tables, c, nb):
        dt = str(tables.dtype).replace("torch.", "")
        out.append(("stencil_tap_tables_sum", name, dt, launches,
                    lambda: stencil_tap_tables_sum(tables, c, nb),
                    lambda fn: _other_taps(fn, tables, c, nb)))

    calls = flagship_calls(dev, num_points, capacities)
    for grp in calls["rank_reduce"]:
        a, k = grp["args"], grp["key"]
        shape = f"M={k['M']} C={k['C']} R={k['R']} T={k['T']} w={int(k['with_weights'])}"
        for g in (a["g"], a["g"].float()):
            reduce_case(f"step {shape}", grp["launches_step"], g, a["rid"],
                        a["start"], a["end"], a["c"], a["with_weights"])
    for grp in calls["stencil_tap_tables_sum"]:
        a, k = grp["args"], grp["key"]
        shape = f"H={k['H']} F={k['F']} C={k['C']}"
        for z in (a["tables"], a["tables"].float()):
            tap_case(f"step {shape}", grp["launches_step"], z, a["c"],
                     a["neighbors"])
    # the gather_rows adjoint at scale 2 (chip_smoke.py phase 3): R = 0
    pc1, pc2 = synthetic_frustum_clouds(1, num_points, seed=0)
    with torch.inference_mode():
        scales = build_pyramid(make_lattice_spec(SFM7, capacities),
                               torch.from_numpy(pc1[0]).to(dev),
                               torch.from_numpy(pc2[0]).to(dev))
    idx = scales[2].pc1_corr_indices
    plan = make_reduce_plan(idx, capacities[2])
    gen = torch.Generator(device=dev).manual_seed(0)
    cot = torch.randn(idx.numel(), 64, generator=gen, device=dev)
    for dt in (torch.bfloat16, torch.float32):
        g = cot.to(dt)[plan.perm.long()].contiguous()
        reduce_case("gather_rows adjoint R=0", 0, g, None, plan.start,
                    plan.end, 64, False)
    for case in reduce_cases():
        for dt in (torch.bfloat16, torch.float32):
            t = to_torch(case, dt, dev)
            reduce_case(f"edge {case.name}", 0, t["g"], t.get("rid"),
                        t["start"], t["end"], case.c, case.with_weights)
    for case in tap_cases():
        nb = torch.from_numpy(case.nb).to(dev)
        for dt in (torch.bfloat16, torch.float32):
            tap_case(f"edge {case.name}", 0,
                     torch.from_numpy(case.tables).to(dev, dt), case.c, nb)
    return out


def run(other: str, num_points: int = NUM_POINTS, capacities=CAPACITIES) -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab compares two builds on a CUDA card")
    dev = torch.device("cuda")
    fns = build_other(other)
    rows = []
    for kernel, case, dt, launches, this, that in _inputs(dev, num_points,
                                                          capacities):
        fn = fns[kernel]
        mine, theirs = this(), that(fn)
        torch.cuda.synchronize()
        equal = bool(torch.equal(mine, theirs))
        times = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            call = this if who == "this" else (lambda: that(fn))
            times[who].append(graph_ms(call, dev))
        ratio = float(np.mean(times["this"]) / np.mean(times["other"]))
        row = dict(kernel=kernel, case=case, dtype=dt, launches=launches,
                   equal=equal, this_ms=times["this"], other_ms=times["other"],
                   ratio=ratio)
        rows.append(row)
        print(f"{kernel} {case} {dt} ({launches} per step): this "
              f"{np.round(times['this'], 5).tolist()} ms, other "
              f"{np.round(times['other'], 5).tolist()} ms, ratio {ratio:.3f}, "
              f"{'bit-identical' if equal else 'OUTPUTS DIFFER'}", flush=True)
    step = {}
    for kernel in _SIGS:
        for who in ("this", "other"):
            step[f"{kernel} {who} ms per step (bf16)"] = sum(
                r["launches"] * float(np.mean(r[f"{who}_ms"])) for r in rows
                if r["kernel"] == kernel and r["dtype"] == "bfloat16")
    return dict(tool="kernel_ab", card=card_line(dev), other=str(other),
                all_equal=all(r["equal"] for r in rows),
                worst_ratio=max(r["ratio"] for r in rows), per_step=step,
                rows=rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="a directory holding the other hplflownet_tpu_torch")
    ap.add_argument("--points", type=int, default=NUM_POINTS)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.other, args.points)
    if args.out:
        with open(args.out, "w") as fd:
            json.dump(result, fd, indent=1)
    print_result({k: v for k, v in result.items() if k != "rows"})
    return result


if __name__ == "__main__":
    main()
