"""A new architecture joins the benchmark as new files only.

A copy of ``flowbench/`` and ``BENCHMARK.json`` gains a toy one-cloud
lattice segmenter (``ToyLattice``: per-point class logits from a pointwise
layer, a splat onto the lattice and a slice back, and a global mean) as new
files: a configuration, an entry with its own ``init_params``, ``CONTROL``
and ``FAULTS``, a plain reference whose work log holds a kind of product
with its own ``flops``, a mix with its own pool maker (one cloud and its
labels), a limits file, and new entries of ``BENCHMARK.json``.  The cell
then runs to a ``correct`` result on the CPU, its control and fault read
over the limit, and no file that was there before has changed.
"""

import copy
import json
import os
import shutil
import subprocess
import sys

from ._util import ROOT, last_json

CONFIG = {
    "source": "a toy stand-in for a one-cloud lattice segmenter (SPLATNet, Su et al., CVPR 2018)",
    "arch": "ToyLattice",
    "scales_filter_map": [[1.0, -1, -1, -1]],
    "width": 8,
    "classes": 4,
    "compute_dtype": "float32",
    "accumulate_dtype": "float32",
    "tf32": False,
    "capacities": {"128": [512]},
    "reduced": [],
    "assumed": {},
}

MIX = {
    "entry": "toy_segment",
    "generator": "toy_cloud",
    "num_points": 2048,
    "pool": 8,
    "classes": 4,
    "extent": 3.0,
    "spread": 0.5,
    "check": {"requests": 4},
}

LIMITS = {"logits_rel_l2": 1e-4}

REFERENCE = '''"""ToyLattice in plain float32 PyTorch, with its work log."""

import math

import torch

from . import lattice
from .model import _Ctx, _dense, _slice, _splat


def param_shapes(cfg):
    c, k = cfg["width"], cfg["classes"]
    return {"embed_kernel": (3, c), "embed_bias": (c,),
            "head_kernel": (3 * c, k), "head_bias": (k,)}


def init_params(cfg, seed, device):
    shapes = param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[n]) for n in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device) * 0.5
    return {n: v.view(shapes[n]) for n, v in zip(names, torch.split(flat, sizes))}


def forward(cfg, capacities, params, points, q=None, log=None):
    ctx = _Ctx(q, log)
    cloud = lattice.build_pyramid(cfg["scales_filter_map"], capacities, points,
                                  points)[0].cloud1
    n = points.shape[0]
    h = torch.relu(_dense(ctx, points, params["embed_kernel"], params["embed_bias"], n))
    s = _slice(ctx, _splat(ctx, h, cloud, capacities[0]), cloud)
    ctx.record(kind="global_mean", flops=float(h.numel()))
    g = h.mean(dim=0, keepdim=True).expand(n, -1)
    return _dense(ctx, torch.cat([h, s, g], dim=1), params["head_kernel"],
                  params["head_bias"], n)
'''

ENTRY = '''"""The toy segmenter's entry: one cloud in, per-point logits out."""

import numpy as np
import torch

from ..control import fp8
from ..reference import toy as ref
from ..reference.toy import init_params  # noqa: F401


class Program:
    def __init__(self, cfg, capacities, params, device):
        from hplflownet_tpu_torch.pipeline import make_lattice_spec
        self.params, self.device = params, device
        self.spec = make_lattice_spec(cfg["scales_filter_map"], capacities)

    def _scale(self, x):
        from hplflownet_tpu_torch.lattice.build import build_pyramid
        return build_pyramid(self.spec, x, x, adjoint_plans=False)[0]

    def __call__(self, points):
        from hplflownet_tpu_torch.ops.bcl import slice_to_points, splat
        p = self.params
        x = torch.from_numpy(points).to(self.device)
        with torch.no_grad():
            sp = self._scale(x)
            h = torch.relu(torch.addmm(p["embed_bias"], x, p["embed_kernel"]))
            v = splat(h, sp.pc1_barycentric, sp.pc1_splat_plan)
            s = slice_to_points(v[1:], sp.pc1_barycentric, sp.pc1_lattice_offset)
            g = h.mean(dim=0, keepdim=True).expand_as(h)
            out = torch.addmm(p["head_bias"], torch.cat([h, s, g], dim=1),
                              p["head_kernel"])
        return out.cpu().numpy()

    def overflow(self, points):
        sp = self._scale(torch.from_numpy(points).to(self.device))
        return int(sp.pc1_overflow)


class Session:
    entry = "forward"

    def __init__(self, cfg, capacities, mix, pool, params, seed, device,
                 program=Program):
        self.cfg, self.capacities, self.mix = cfg, capacities, mix
        self.pool, self.params, self.seed, self.device = pool, params, seed, device
        self.program = program(cfg, capacities, params, device)
        self.served = []

    def warm(self, order):
        self.program(self.pool.points[0])

    def call(self, k):
        logits = self.program(self.pool.points[k])
        self.served.append((k, logits))
        return bool(np.isfinite(logits).all())

    def overflowing(self):
        return {k for k in {k for k, _ in self.served}
                if self.program.overflow(self.pool.points[k])}

    def release(self):
        self.program = None

    def _reference(self, k, log=None):
        x = torch.from_numpy(self.pool.points[k]).to(self.device)
        with torch.no_grad():
            return ref.forward(self.cfg, self.capacities, self.params, x, log=log)

    def check(self):
        rng = np.random.default_rng(np.random.SeedSequence([int(self.seed) % (1 << 64), 7]))
        n = min(int(self.mix["check"]["requests"]), len(self.served))
        worst = 0.0
        for i in sorted(int(j) for j in rng.choice(len(self.served), n, replace=False)):
            k, logits = self.served[i]
            want = self._reference(k).cpu().numpy().astype(np.float64)
            worst = max(worst, float(np.linalg.norm(logits - want) / np.linalg.norm(want)))
        return {"logits_rel_l2": {"value": worst}}

    def work(self, k):
        log = []
        self._reference(k, log=log)
        return log


class Control:
    def __init__(self, cfg, capacities, params, device):
        self.cfg, self.capacities, self.params, self.device = cfg, capacities, params, device

    def __call__(self, points):
        x = torch.from_numpy(points).to(self.device)
        with torch.no_grad():
            return ref.forward(self.cfg, self.capacities, self.params, x, q=fp8).cpu().numpy()

    def overflow(self, points):
        return 0


class StaleLogits(Program):
    last = None

    def __call__(self, points):
        logits = super().__call__(points)
        stale = self.last if self.last is not None else np.zeros_like(logits)
        self.last = logits
        return stale


CONTROL = Control
FAULTS = {"stale_logits": StaleLogits}
'''

POOL_MAKER = '''"""One labelled cloud per pool item: points around one centre per class."""

from typing import NamedTuple

import numpy as np


class Pool(NamedTuple):
    points: list          # (N, 3) float32
    labels: list          # (N,) int64


def make_pool(mix, seed):
    points, labels = [], []
    n, k = int(mix["num_points"]), int(mix["classes"])
    for i in range(int(mix["pool"])):
        rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), i]))
        lab = rng.integers(0, k, n)
        centres = rng.uniform(-mix["extent"], mix["extent"], (k, 3))
        pts = centres[lab] + mix["spread"] * rng.standard_normal((n, 3))
        points.append(pts.astype(np.float32))
        labels.append(lab.astype(np.int64))
    return Pool(points, labels)


def request_order(mix, seed):
    p = int(mix["pool"])
    rng = np.random.default_rng(np.random.SeedSequence([int(seed) % (1 << 64), p, 1]))
    while True:
        yield from (int(k) for k in rng.permutation(p))
'''

CONFIG_ENTRY = {"name": "toy", "source": CONFIG["source"],
                "file": "flowbench/configs/toy.json", "reduced": [],
                "why": "a one-cloud lattice segmenter: splat, slice, per-point logits"}
WORKLOAD = {"name": "toy-fwd", "config": "toy", "traffic": "toy-cloud", "chips": 1,
            "why": "one labelled cloud per request, one client: build, splat, slice, head"}

PROBE = '''
import json
from flowbench import readings, run, work
from flowbench.control import CONTROLS
from flowbench.faults import FAULTS
from flowbench.entries import toy_segment
assert CONTROLS["toy_segment"] is toy_segment.Control
assert FAULTS["toy_segment"] == {"stale_logits": toy_segment.StaleLogits}
bench = json.loads((run.ROOT / "BENCHMARK.json").read_text())
cell = next(w for w in bench["workloads"] if w["name"] == "toy-fwd")
got = {"program": readings.reading(cell, 5, None, 2),
       "control": readings.reading(cell, 6, CONTROLS["toy_segment"], 2),
       "stale_logits": readings.reading(cell, 7, toy_segment.StaleLogits, 2)}
cfg, mix, caps, dev = run.cell_setup(cell)
traffic = run.pool_maker(mix)
session = toy_segment.Session(cfg, caps, mix, traffic.make_pool(mix, 5),
                              toy_segment.init_params(cfg, 5, dev), 5, dev)
log = session.work(0)
got["kinds"] = sorted({e["kind"] for e in log})
got["flops"] = work.model_flops(log)
got["closed_form"] = sum(2.0 * e["rows"] * e["k"] * e["n"] for e in log if e["kind"] == "dense") \\
    + sum(2.0 * e["entries"] * e["c"] for e in log if e["kind"] in ("splat", "slice")) \\
    + 128 * 8
print(json.dumps(got))
'''


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in root.rglob("*")
            if p.is_file() and "__pycache__" not in p.parts}


def _write(root, rel, text):
    path = root / rel
    assert not path.exists(), f"{rel} is not a new file"
    path.write_text(text)


def test_a_new_architecture_is_new_files_only(tmp_path):
    shutil.copytree(ROOT / "flowbench", tmp_path / "flowbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    before = _files(ROOT / "flowbench")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())

    new = copy.deepcopy(bench)
    new["configs"].append(CONFIG_ENTRY)
    new["workloads"].append(WORKLOAD)
    next(m for m in new["end_to_end"] if m["name"] == "fwd_device_ms")["workloads"].append(
        WORKLOAD["name"])
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(new, indent=1))
    fb = tmp_path / "flowbench"
    _write(fb, "configs/toy.json", json.dumps(CONFIG))
    _write(fb, "traffic/toy-cloud.json", json.dumps(MIX))
    _write(fb, "traffic/toy_cloud.py", POOL_MAKER)
    _write(fb, "limits/toy-fwd.json", json.dumps(LIMITS))
    _write(fb, "reference/toy.py", REFERENCE)
    _write(fb, "entries/toy_segment.py", ENTRY)

    env = dict(os.environ, FLOWBENCH_CPU_REHEARSAL="1", PYTHONPATH=str(ROOT),
               PYTHONDONTWRITEBYTECODE="1")
    r = subprocess.run([sys.executable, "-m", "flowbench.run", "--workload", "toy-fwd",
                        "--seed", "0", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    res = last_json(r.stdout)
    assert res["correct"] is True, res["checks"]
    assert set(res["checks"]) == {"logits_rel_l2"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert "setup_s" in res["metrics"]
    assert "window: " in r.stderr and " forward calls in " in r.stderr

    p = subprocess.run([sys.executable, "-c", PROBE], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    got = last_json(p.stdout)
    assert got["program"]["logits_rel_l2"] <= LIMITS["logits_rel_l2"], got
    assert got["control"]["logits_rel_l2"] > LIMITS["logits_rel_l2"], got
    assert got["stale_logits"]["logits_rel_l2"] > LIMITS["logits_rel_l2"], got
    assert got["kinds"] == ["dense", "global_mean", "slice", "splat"]
    assert got["flops"] == got["closed_form"]

    after = _files(fb)
    assert {k: after[k] for k in before} == before
    # the copy's BENCHMARK.json less the toy's entries is the repository's
    got = json.loads((tmp_path / "BENCHMARK.json").read_text())
    assert got["configs"].pop() == CONFIG_ENTRY and got["workloads"].pop() == WORKLOAD
    fwd = next(m for m in got["end_to_end"] if m["name"] == "fwd_device_ms")
    assert fwd["workloads"].pop() == WORKLOAD["name"]
    assert got == bench
