"""The readings that a cell's limits are set from, in one process.

    python -m flowbench.readings --workload <cell> --seeds 101,102,... \
        [--control-seeds 201,202,203] [--fault-seeds 301,302,303] \
        [--requests 8] [--out file.jsonl]

For each seed: the cell's set-up (weights, pool, program, warm-up), a
short stretch at the cell's own load (``--requests`` requests of a
forward session; a training session's check steps are its set-up), then
the check against the reference, as a run makes it.  ``--control-seeds``
does the same with the control (``flowbench.control``, or the entry's own
``CONTROL``) in the program's place, and ``--fault-seeds`` with each fault
of the entry (``flowbench.faults``, or the entry's own ``FAULTS``)
planted.  One JSON line per reading: ``{"kind", "seed", "checks"}``.
Needs a CUDA card unless ``FLOWBENCH_CPU_REHEARSAL=1``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from .control import CONTROLS
from .faults import FAULTS
from .run import ROOT, cell_setup, pool_maker
from .traffic.generator import load_mix

__all__ = ["reading", "main"]


def reading(cell: dict, seed: int, program=None, requests: int = 8) -> dict:
    cfg, mix, capacities, device = cell_setup(cell)
    entry = importlib.import_module(f"flowbench.entries.{mix['entry']}")
    traffic = pool_maker(mix)
    kw = {} if program is None else {"program": program}
    session = entry.Session(cfg, capacities, mix, traffic.make_pool(mix, seed),
                            entry.init_params(cfg, seed, device), seed, device, **kw)
    order = traffic.request_order(mix, seed)
    session.warm(order)
    if session.entry == "forward":
        for _ in range(requests):
            session.call(next(order))
    session.release()
    return {k: v["value"] for k, v in session.check().items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    entry = load_mix(cell["traffic"])["entry"]
    seeds = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    jobs = [("program", s, None) for s in seeds(args.seeds)]
    jobs += [("control", s, CONTROLS[entry]) for s in seeds(args.control_seeds)]
    jobs += [(f"fault:{name}", s, cls) for s in seeds(args.fault_seeds)
             for name, cls in FAULTS[entry].items() if name != "unchanged"]
    out = open(args.out, "a") if args.out else None
    try:
        for kind, seed, program in jobs:
            t = time.perf_counter()
            try:
                checks = reading(cell, seed, program, args.requests)
            except Exception as exc:  # a crashed control or fault is a reading
                checks = {"error": f"{type(exc).__name__}: {exc}"}
            line = json.dumps({"workload": cell["name"], "kind": kind, "seed": seed,
                               "checks": checks,
                               "seconds": round(time.perf_counter() - t, 3)})
            print(line, flush=True)
            if out:
                out.write(line + "\n")
                out.flush()
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
