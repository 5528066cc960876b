"""The host builder against the device builder on one synthetic pair.

    python -m hplflownet_tpu_torch.native [--device cpu] [--points 8192]
        [--scale 1.0] [--capacity N] [--seed 0] [--out f.json]

Builds the lattice of both clouds of a synthetic FT3D-like pair
(``lattice.capacity.synthetic_frustum_clouds``) at one scale twice: with
the device builder (``lattice.build``: vertex table, blur neighbours at
ring 1, correlation tables at ring 1) on ``--device`` (the card by
default), and with :class:`~.bindings.HostLatticeBuilder` from the keys of
``lattice.geometry`` on the CPU.  The dense ids, the unique keys, the
neighbour tables and the correlation tables (the unique-offset form
expanded to the host's (F, Cc, H)) must be equal; any difference raises.
Prints one JSON line with the host builder's time by call (host clock).
"""

from __future__ import annotations

import argparse
import time

import torch

from ..device import resolve_device
from ..lattice.build import (_build_from_elevated, _corr_tables,
                             _neighbor_table, _unpack_keys)
from ..lattice.capacity import synthetic_frustum_clouds
from ..lattice.geometry import elevate, simplex_from_elevated
from ..lattice.offsets import neighborhood_offsets
from ..tools.timing import card_line, print_result
from .bindings import HostLatticeBuilder, pack_keys_i64

__all__ = ["run", "main"]


def run(device=None, num_points: int = 8192, scale: float = 1.0,
        capacity: int | None = None, seed: int = 0, d: int = 3) -> dict:
    """-> the comparison's result; raises AssertionError on a difference.
    ``capacity`` defaults to 4 vertices a point (no overflow)."""
    dev = resolve_device(device)
    cap = capacity or 4 * num_points
    offs = neighborhood_offsets(1, d)
    pcs = synthetic_frustum_clouds(1, num_points, seed=seed)
    with torch.inference_mode():
        clouds = []
        for pc in pcs:
            pts = torch.from_numpy(pc[0]).to(dev)
            valid = torch.ones(num_points, dtype=torch.bool, device=dev)
            cl = _build_from_elevated(elevate(pts, scale), valid, cap)
            clouds.append((cl, _neighbor_table(cl, offs, d)))
        corr1, uniq, inverse, _ = _corr_tables(clouds[0][0], clouds[1][0],
                                               offs, offs, d)
    keys = [simplex_from_elevated(elevate(torch.from_numpy(pc[0]), scale)).keys
            for pc in pcs]

    hb = HostLatticeBuilder(d)
    ms = {}

    def timed(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        ms[name] = ms.get(name, 0.0) + (time.perf_counter() - t) * 1e3
        return out

    host = [timed("build_cloud", hb.build_cloud, k, cap) for k in keys]
    nbs = [timed("neighbor_table", hb.neighbor_table, u, n, offs)
           for u, _, n in host]
    pc1c, pc2c = timed("corr_tables", hb.corr_tables, host[0][0], host[0][2],
                       host[1][0], host[1][2], offs, offs)

    equal = {}
    for i, ((cl, nb), (unique, ids, total), hnb) in enumerate(
            zip(clouds, host, nbs)):
        n = int(cl.num_valid)
        dkeys = pack_keys_i64(_unpack_keys(cl.vkeys, d, 10)[:n].cpu(), d)
        equal[f"pc{i + 1}"] = dict(
            num_valid=total == n and int(cl.overflow) == 0,
            ids=torch.equal(ids, cl.lattice_offset.cpu()),
            unique_keys=torch.equal(unique[:n], dkeys),
            neighbors=torch.equal(hnb, nb.cpu()))
    equal["corr_pc1"] = torch.equal(pc1c, corr1.cpu())
    equal["corr_pc2"] = torch.equal(pc2c, uniq.cpu()[inverse.cpu().long()])
    flat = [v for e in equal.values()
            for v in (e.values() if isinstance(e, dict) else [e])]
    if not all(flat):
        raise AssertionError(f"host and device builders differ: {equal}")
    return {"tool": "native", "points": num_points, "scale": scale,
            "capacity": cap, "num_valid": [h[2] for h in host],
            "equal": equal, "host_ms": ms,
            "host_ms_total": sum(ms.values()), "clock": "host clock",
            "device_builder": str(dev), "card": card_line(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="the device builder's device (the card by default)")
    ap.add_argument("--points", type=int, default=8192)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--capacity", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    res = run(args.device, args.points, args.scale, args.capacity, args.seed)
    print_result(res, args.out)
    return res
