"""Run one cell of the benchmark once.

    python -m flowbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, this package and
the measured program, ``hplflownet_tpu_torch``.  The cell (an entry of
``BENCHMARK.json``'s ``workloads``) names a configuration
(``flowbench/configs/<config>.json``) and a traffic mix
(``flowbench/traffic/<traffic>.json``), and the mix names the entry
(``flowbench/entries/<entry>.py``) and, optionally, its pool maker
(``flowbench/traffic/<generator>.py``, ``generator.py`` by default).  A run:

1. set-up: makes the weights on the card from the seed (the entry's
   ``init_params``), the pool from the seed (the pool maker's
   ``make_pool``), the program, and the entry's warm-up calls;
2. the window: a closed loop of requests, pool pairs in an order drawn from
   the seed, for ``--seconds`` on the host clock;
3. a profiled stretch of a few more requests (``torch.profiler``, after
   the window, so that it costs the window nothing): the device time per
   request of the end-to-end ``*_device_ms`` metrics and, with ``--trace
   1``, of the per-layer metrics; then, traced only, each per-layer
   metric's own spans (``flowbench/metrics/<name>.py``);
4. reads the peak of the card's memory, frees the program, and runs the
   plain reference (``flowbench/reference``) on a sample of what the
   window produced: ``correct``, with each number compared beside its
   limit (``flowbench/limits/<cell>.json``);
5. prints one JSON line: ``correct``, ``attempted``, ``failed``,
   ``metrics`` (the cell's ``end_to_end`` metrics, or with ``--trace 1``
   its ``per_layer`` ones), ``device``, ``breakdown`` (traced) and
   ``checks``, last.

It exits with 2 and prints no result without a CUDA card, with fewer cards
than the cell asks for, or when the program is missing, and with 3 if any
module of JAX or of the JAX package is loaded when the window has closed.
``FLOWBENCH_CPU_REHEARSAL=1`` runs a cell on the CPU at the rehearsal
size (the configuration's ``capacities["128"]``: 128 points, a pool of 4)
with the program's plain versions; such a line reports ``"platform":
"cpu"`` and no metric read from a device trace.
"""

from __future__ import annotations

import os
import time

_WALL0 = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

__all__ = ["main", "run", "cell_setup", "pool_maker", "process_start", "FORBIDDEN"]

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hplflownet_tpu")
REHEARSAL_ENV = "FLOWBENCH_CPU_REHEARSAL"
REHEARSAL = {"points": "128", "pool": 4, "requests": 2}
PROFILED_CALLS = {"forward": 5, "train": 3}


def _log(msg: str) -> None:
    print(f"[flowbench] {msg}", file=sys.stderr, flush=True)


def process_start() -> float:
    """This process's start on the wall clock (Linux ``/proc``), else the
    time this module was imported."""
    try:
        with open("/proc/self/stat") as fd:
            ticks = float(fd.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fd:
            uptime = float(fd.read().split()[0])
        return time.time() - uptime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return _WALL0


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def load_metric(name: str):
    """``flowbench/metrics/<name>.py`` as a module."""
    path = PKG / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "flowbench.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The metric entries of ``kind`` (end_to_end, per_layer) that ``cell``
    reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


class Record:
    """What a run measured, for the metric readers."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def _power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
        return out.splitlines()[0] if out else "not read"
    except (OSError, subprocess.TimeoutExpired):
        return "not read"


def cell_setup(cell: dict):
    """(configuration, mix, capacities, device) of a cell, the mix and the
    capacities at the rehearsal size under ``FLOWBENCH_CPU_REHEARSAL=1``;
    TF32 as the configuration states it."""
    import torch

    from .configs import load_config
    from .traffic.generator import load_mix
    cfg, mix = load_config(cell["config"]), load_mix(cell["traffic"])
    points = str(mix["num_points"])
    device = torch.device("cuda")
    if os.environ.get(REHEARSAL_ENV) == "1":
        points, device = REHEARSAL["points"], torch.device("cpu")
        mix = dict(mix, num_points=int(points),
                   pool=min(int(mix["pool"]), REHEARSAL["pool"]),
                   check=dict(mix["check"], requests=REHEARSAL["requests"]))
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    return cfg, mix, cfg["capacities"][points], device


def pool_maker(mix: dict):
    """The module that makes the mix's pool and request order, with
    ``make_pool(mix, seed)`` and ``request_order(mix, seed)``:
    ``flowbench/traffic/<mix["generator"]>.py``, ``generator.py`` where the
    mix names none."""
    return importlib.import_module(f"flowbench.traffic.{mix.get('generator', 'generator')}")


def run(args, session_kw=None) -> dict | None:
    """One run; the result dict, or None where no result may be printed."""
    import torch

    rehearsal = os.environ.get(REHEARSAL_ENV) == "1"
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        raise SystemExit(f"no workload {args.workload!r} in BENCHMARK.json")
    if not rehearsal:
        if not torch.cuda.is_available():
            _log("no CUDA device: no result")
            return None
        if torch.cuda.device_count() < int(cell["chips"]):
            _log(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
                 f"{cell['chips']}: no result")
            return None
    try:
        importlib.import_module("hplflownet_tpu_torch")
    except ImportError as exc:
        _log(f"the measured program is missing ({exc}): no result")
        return None

    cfg, mix, capacities, device = cell_setup(cell)
    if not rehearsal:
        torch.set_num_threads(1)

    entry = importlib.import_module(f"flowbench.entries.{mix['entry']}")
    traffic = pool_maker(mix)
    params = entry.init_params(cfg, args.seed, device)
    pool = traffic.make_pool(mix, args.seed)
    order = traffic.request_order(mix, args.seed)
    session = entry.Session(cfg, capacities, mix, pool, params, args.seed,
                            device, **(session_kw or {}))
    session.warm(order)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    setup_s = time.time() - process_start()
    _log(f"set-up {setup_s:.3f} s; window of {args.seconds} s")

    # ---- the window ----
    lat, ks, ok = [], [], []
    t0 = time.perf_counter()
    end = t0 + args.seconds
    now = t0
    while now < end:
        k = next(order)
        good = session.call(k)
        t = time.perf_counter()
        lat.append((t - now) * 1e3)
        ks.append(k)
        ok.append(good)
        now = t
    window_s = now - t0
    tenth = max(1, len(lat) // 10)
    _log(f"window: {len(ks)} {session.entry} calls in {window_s:.3f} s; ms per "
         f"call: median {statistics.median(lat):.2f}, first tenth "
         f"{statistics.fmean(lat[:tenth]):.2f}, last tenth "
         f"{statistics.fmean(lat[-tenth:]):.2f}, most {max(lat):.2f}")

    from .trace import profile_calls
    spans, readers = {}, {}
    per_layer = cell_metrics(bench, cell["name"], "per_layer")
    prof_ks = [next(order) for _ in range(PROFILED_CALLS[session.entry])]
    trace = profile_calls(session.call, prof_ks, device)
    _log(f"profiled {len(prof_ks)} calls: {len(trace.device_ops)} device ops, "
         f"{trace.busy_s * 1e3 / len(prof_ks):.4f} device ms a call")
    if args.trace:
        for m in per_layer:
            readers[m["name"]] = mod = load_metric(m["name"])
            if hasattr(mod, "span"):
                spans[m["name"]] = mod.span(session)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    bad_pairs = session.overflowing()
    failed = sum(1 for k, g in zip(ks, ok) if not g or k in bad_pairs)
    session.release()

    checks = session.check()
    limits = json.loads((PKG / "limits" / f"{cell['name']}.json").read_text())
    for name, c in checks.items():
        c["limit"] = limits[name]
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    work = {}
    if args.trace:
        work = {k: session.work(k) for k in sorted(set(ks) | set(prof_ks))}

    stray = forbidden_modules()
    if stray:
        _log(f"modules of JAX or the JAX package are loaded: {stray}: no result")
        return {"_forbidden": stray}

    rec = Record(entry=session.entry, cfg=cfg, setup_s=setup_s, window_s=window_s,
                 completed=len(ks), latencies_ms=lat, window_ks=ks, trace=trace,
                 profiled_ks=prof_ks, spans=spans, work=work,
                 device=device, session=session)
    kind = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    card = "cpu" if device.type != "cuda" else _power_limit()
    for m in cell_metrics(bench, cell["name"], kind):
        mod = readers.get(m["name"]) or load_metric(m["name"])
        value = mod.read(rec)
        if value is None:
            continue
        entry_out = {"value": float(value[0] if isinstance(value, tuple) else value),
                     "unit": m["unit"]}
        if isinstance(value, tuple):
            entry_out["bound_by"] = value[1]
            entry_out["card"] = card
        metrics[m["name"]] = entry_out
    dev_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
               "kind": torch.cuda.get_device_name() if device.type == "cuda" else "cpu",
               "count": int(cell["chips"]) if device.type == "cuda" else 0,
               "memory_peak_bytes": int(peak), "card": card}
    result = {"correct": bool(correct), "attempted": len(ks), "failed": failed,
              "metrics": metrics, "device": dev_out}
    if args.trace:
        if device.type == "cuda":
            dev_out["busy_s"] = trace.busy_s
            dev_out["window_s"] = trace.window_s
            result["breakdown"] = {"device_ops": trace.top_ops(),
                                   "idle_gaps": trace.idle_gaps()}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]}
                        for k, c in checks.items()}
    return result


def main(argv=None, session_kw=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args, session_kw)
    if result is None:
        return 2
    if "_forbidden" in result:
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
