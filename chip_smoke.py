#!/usr/bin/env python3
"""Smoke run of hplflownet_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line with its elapsed seconds:

1. device   the card's name and power limit (nvidia-smi);
2. build    compile every CUDA kernel of the main path with nvcc, in
            parallel, into hplflownet_tpu_torch/_build/;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the main path's shapes, in float32 and bfloat16: max error,
            kernel and plain time, the bound, and a library yardstick;
4. reference  the float32 forward through the kernels on a 64-point pair
            against the JAX package's output frozen in
            tests/data/torch_port_ref_n64.npz;
5. main path  one 8192-point pair through ``pipeline.flow_forward`` at full
            width (7 scales, bf16 compute): the launch counts of every
            kernel, the flow's shape and finiteness, zero overflow, the same
            forward with the plain versions forced, and pairs/s.

Then one JSON line listing every kernel, the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  Without a CUDA card, or without the package beside
it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback

SFM7 = [[3.0, 1, -1, -1], [2.0, 1, -1, -1], [1.0, 1, 1, 1],
        [0.5, 1, 1, 1], [0.25, 1, 1, 1], [0.125, 1, 1, 1],
        [0.0625, 1, 1, 1]]
CAPACITIES = [25600, 31872, 12928, 3584, 896, 256, 128]
NUM_POINTS = 8192
REF_NPZ = os.path.join("tests", "data", "torch_port_ref_n64.npz")
DEVICE = "cuda"   # a CPU rehearsal of the phases may set "cpu" after import

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def sync() -> None:
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    if DEVICE != "cuda":                       # CPU rehearsal only
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want, atol: float, rtol: float, what: str) -> float:
    import torch
    got = got.float()
    want = want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite kernel output")
    diff = (got - want).abs()
    bad = diff > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(
            f"{what}: {int(bad.sum())} elements beyond atol {atol} + rtol "
            f"{rtol} (max abs err {float(diff.max()):.3e})")
    return float(diff.max())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    smi_line = smi.strip().splitlines()[0].strip()
    log(f"device: torch sees {torch.cuda.device_count()} card(s); "
        f"card 0 = {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    log(f"nvidia-smi: {smi_line}")
    return name, smi_line


def phase_build():
    from hplflownet_tpu_torch.kernels import _build
    built = _build.build(verbose=True)
    for name, (secs, out) in built.items():
        info = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"built {name}.cu in {secs:.1f} s")
        for ln in info:
            log(f"  ptxas: {ln}")
    for name in _build.SOURCES:
        _build.load(name)


def _lattice_case_tables(dev):
    """Real tables of the flagship pair, for the kernels' shapes."""
    import torch
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.pipeline import make_lattice_spec
    from hplflownet_tpu_torch.lattice import build_pyramid
    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    spec = make_lattice_spec(SFM7, CAPACITIES)
    with torch.inference_mode():
        return build_pyramid(spec, torch.from_numpy(pc1[0]).to(dev),
                             torch.from_numpy(pc2[0]).to(dev),
                             adjoint_plans=False)


def phase_kernels(results):
    import torch
    from hplflownet_tpu_torch.kernels.stencil import (
        stencil_gather_matmul, stencil_gather_matmul_plain)
    from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scales = _lattice_case_tables(dev)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    # name, neighbour table, table rows, C_in, C_out, act slope, output
    # dtype, bias: as the main path calls the kernel
    nb0, h0 = scales[0].pc1_blur_neighbors, CAPACITIES[0]
    h2 = CAPACITIES[2]
    stencil_cases = [
        ("bcn1 blur", nb0, h0, 68, 64, 0.1, "compute", True),
        ("bcn1_ decoder blur", nb0, h0, 580, 1024, 0.1, "compute", True),
        ("corr_self", scales[2].pc1_corr_indices, h2, 128, 32, None, "float32", True),
        ("corr_cross", scales[2].pc2_corr_uniq, h2, 64, 480, None, "float32", False),
    ]
    stencil_rows = []
    for name, nb, h_in, c_in, c_out, slope, out_kind, has_bias in stencil_cases:
        nb = nb.contiguous()
        f, h_out = nb.shape
        nnz = int((nb >= 0).sum())
        table32 = randn(h_in, c_in)
        w32 = randn(f, c_in, c_out, scale=(2.0 / (f * (c_in + c_out))) ** 0.5)
        bias = randn(c_out, scale=0.1)
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            table, w = table32.to(dt), w32.to(dt)
            out_dt = dt if out_kind == "compute" else torch.float32
            b = bias if has_bias else None
            got = stencil_gather_matmul(table, nb, w, bias=b, act_slope=slope,
                                        out_dtype=out_dt)
            want = stencil_gather_matmul_plain(table, nb, w, bias=b,
                                               act_slope=slope, out_dtype=out_dt)
            sync()
            # float32 sums differ only in order (K = F * C_in terms); a
            # bf16 output may then round one bf16 ulp (2^-8) either way
            atol, rtol = ((1e-3, 1e-4) if out_dt == torch.float32
                          else (1e-2, 1e-2))
            err = max_err(got, want, atol, rtol, f"stencil {name} {dtn}")
            ms = cuda_ms(lambda: stencil_gather_matmul(
                table, nb, w, bias=b, act_slope=slope, out_dtype=out_dt))
            plain_ms = cuda_ms(lambda: stencil_gather_matmul_plain(
                table, nb, w, bias=b, act_slope=slope, out_dtype=out_dt), reps=3)
            spread = torch.cat([table.new_zeros(1, c_in), table])[
                (nb.t() + 1).long()].reshape(h_out, f * c_in)
            wm = w.reshape(f * c_in, c_out)
            lib_ms = cuda_ms(lambda: torch.matmul(spread, wm))
            del spread
            s_in, s_out = table.element_size(), got.element_size()
            nbytes = (table.numel() * s_in + nb.numel() * 4 + w.numel() * s_in
                      + got.numel() * s_out + (c_out * 4 if b is not None else 0))
            flops = 2.0 * nnz * c_in * c_out
            bms, by = bound_ms(nbytes, flops, dtn)
            row = dict(case=name, dtype=dtn, shape=f"H={h_out} F={f} C_in={c_in} C_out={c_out}",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms,
                       tflops=flops / ms / 1e9)
            stencil_rows.append(row)
            log(f"stencil_gather_matmul {name} {dtn} [{row['shape']}]: "
                f"max_abs_err {err:.3e} (atol {atol} rtol {rtol}); kernel "
                f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
                f"matmul over the spread {lib_ms:.4f} ms, bound {bms:.4f} ms ({by})")

    # the splat stream at scale 2 (the 127k x 68 case) and scale 0
    reduce_rows = []
    for name, si, n_pts, c in (("scale-2 splat (bcn3)", 2, CAPACITIES[1], 68),
                               ("scale-0 splat (bcn1)", 0, NUM_POINTS, 68)):
        sp = scales[si]
        plan = sp.pc1_splat_plan
        bary = sp.pc1_barycentric
        feats32 = randn(n_pts, c)
        perm = plan.perm.long()
        r = bary.shape[1]
        rid = (perm % r).to(torch.int32).contiguous()
        entries = int((plan.end - plan.start).clamp(min=0).sum())
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            g = torch.cat([feats32.to(dt), bary.to(dt)], 1)[perm // r].contiguous()
            got = rank_reduce(g, rid, plan.start, plan.end, c, True)
            again = rank_reduce(g, rid, plan.start, plan.end, c, True)
            want = rank_reduce_plain(g, rid, plan.start, plan.end, c, True)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"rank_reduce {name} {dtn}: rerun differs")
            # float32 run sums of a few bf16/f32 products vs the float64 prefix
            err = max_err(got, want, 1e-4, 1e-5, f"rank_reduce {name} {dtn}")
            ms = cuda_ms(lambda: rank_reduce(g, rid, plan.start, plan.end, c, True))
            plain_ms = cuda_ms(lambda: rank_reduce_plain(
                g, rid, plan.start, plan.end, c, True), reps=3)
            # yardstick: index_add_ of the already-weighted stream by vertex id
            w_sel = torch.gather(g[:, c:], 1, rid.long()[:, None])
            sv = torch.cat([g[:, :c] * w_sel, w_sel], 1).float()
            ids = plan.ids[perm].long()
            keep = ids >= 0
            sv, ids = sv[keep].contiguous(), ids[keep].contiguous()
            t_out = plan.start.shape[0]
            lib_ms = cuda_ms(lambda: torch.zeros(t_out, c + 1, device=dev)
                             .index_add_(0, ids, sv))
            nbytes = (entries * g.shape[1] * g.element_size() + entries * 4
                      + 2 * t_out * 4 + got.numel() * 4)
            flops = 2.0 * entries * (c + 1)
            bms, by = bound_ms(nbytes, flops, "float32")
            row = dict(case=name, dtype=dtn,
                       shape=f"M={g.shape[0]} C={c} R={r} T={t_out}",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms)
            reduce_rows.append(row)
            log(f"rank_reduce {name} {dtn} [{row['shape']}]: max_abs_err "
                f"{err:.3e} (atol 1e-4 rtol 1e-5), rerun bit-identical; kernel "
                f"{ms:.4f} ms, plain {plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms, "
                f"bound {bms:.4f} ms ({by})")
    results["stencil"] = stencil_rows
    results["reduce"] = reduce_rows


def phase_reference():
    """Float32 forward through the kernels vs the frozen JAX output."""
    import numpy as np
    import torch
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    ref = np.load(REF_NPZ)
    model = HPLFlowNet(SFM7, compute_dtype="float32", device=DEVICE)
    params_from_jax(seeded_jax_params(model, int(ref["seed"])), model)
    spec = make_lattice_spec(SFM7, [int(c) for c in ref["capacities"]])
    got = flow_forward(model, spec, ref["pc1"], ref["pc2"],
                       adjoint_plans=False).cpu().numpy()
    want = ref["flow"]
    err = float(np.abs(got - want).max())
    rel = err / float(np.abs(want).max())
    # the CPU test holds the same forward to atol 1e-3 / max-rel 5e-3
    if not (got.shape == want.shape and np.isfinite(got).all()
            and err <= 1e-3 and rel <= 5e-3):
        raise AssertionError(f"n=64 float32 flow vs JAX: max abs {err:.3e}, "
                             f"max rel {rel:.3e}, shape {got.shape}")
    log(f"n=64 float32 flow through the kernels vs frozen JAX output: "
        f"max abs {err:.3e}, max rel {rel:.3e} (limits 1e-3 / 5e-3)")


def phase_main_path(results):
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.kernels.splat import rank_reduce
    from hplflownet_tpu_torch.kernels.stencil import stencil_gather_matmul
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec

    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    pc1, pc2 = pc1[0], pc2[0]
    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)

    wrappers = {"stencil_gather_matmul": stencil_gather_matmul,
                "rank_reduce": rank_reduce}
    for w in wrappers.values():
        w.launches = 0
    flow = flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    sync()
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"main path launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{k} was not launched on the main path")
    results["launches"] = launches

    out = flow.float().cpu().numpy()
    if out.shape != (NUM_POINTS, 3) or not np.isfinite(out).all():
        raise AssertionError(f"flow shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    with torch.inference_mode():
        scales = build_pyramid(spec, torch.from_numpy(pc1).to(DEVICE),
                               torch.from_numpy(pc2).to(DEVICE),
                               adjoint_plans=False)
    oflow = {i: [int(s.pc1_overflow), int(s.pc2_overflow),
                 int(s.probe_overflow), int(s.stencil_overflow)]
             for i, s in enumerate(scales)}
    if any(any(v) for v in oflow.values()):
        raise AssertionError(f"overflow counters not zero: {oflow}")
    counts = [[int(s.pc1_num_valid), int(s.pc2_num_valid)] for s in scales]
    log(f"flow {out.shape} finite, |flow| max {np.abs(out).max():.4f}; "
        f"all overflow counters 0; vertices per scale {counts}")

    before = dict(launches)
    with plain_kernels():
        flow_plain = flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    sync()
    if any(w.launches != before[k] for k, w in wrappers.items()):
        raise AssertionError("a kernel launched inside plain_kernels()")
    ref = flow_plain.float().cpu().numpy()
    err = float(np.abs(out - ref).max())
    rel = err / float(np.abs(ref).max())
    # bf16 activations: a one-ulp rounding flip (2^-8) in one layer spreads
    # through the next ones, so the two orders of summation differ by ~1e-2
    if rel > 5e-2:
        raise AssertionError(f"bf16 flow, kernels vs plain: max abs {err:.3e}, "
                             f"max rel {rel:.3e} > 5e-2")
    log(f"bf16 flow, kernels vs plain versions on the card: max abs "
        f"{err:.3e}, max rel {rel:.3e} (limit 5e-2)")

    def fwd():
        return flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    reps = 5
    ms = cuda_ms(fwd, reps=reps, warmup=1)
    results["pairs_per_s"] = 1e3 / ms
    log(f"flagship forward (lattice build + model, bf16, host arrays in): "
        f"{ms:.2f} ms/pair = {1e3 / ms:.2f} pairs/s over {reps} reps")
    with plain_kernels():
        ms_plain = cuda_ms(fwd, reps=2, warmup=1)
    results["plain_pairs_per_s"] = 1e3 / ms_plain
    log(f"same forward with the plain versions: {ms_plain:.2f} ms/pair")


def kernels_line(results) -> dict:
    stencil = [r for r in results["stencil"]
               if r["case"] == "bcn1_ decoder blur" and r["dtype"] == "bfloat16"][0]
    reduce = [r for r in results["reduce"]
              if r["case"].startswith("scale-2") and r["dtype"] == "bfloat16"][0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    return {"kernels": [
        dict(name="stencil_gather_matmul", route="cuda",
             source="hplflownet_tpu_torch/csrc/stencil_gather_matmul.cu",
             replaces="hplflownet_tpu/ops/pallas_stencil.py:270",
             launches=results["launches"]["stencil_gather_matmul"],
             **{k: stencil[k] for k in keys},
             shape=stencil["shape"] + " bf16",
             max_abs_err_all=max(r["max_abs_err"] for r in results["stencil"])),
        dict(name="rank_reduce", route="cuda",
             source="hplflownet_tpu_torch/csrc/rank_reduce.cu",
             replaces="hplflownet_tpu/ops/pallas_stencil.py:735",
             launches=results["launches"]["rank_reduce"],
             **{k: reduce[k] for k in keys},
             shape=reduce["shape"] + " bf16",
             max_abs_err_all=max(r["max_abs_err"] for r in results["reduce"])),
    ]}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script measures the port on a card", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    os.chdir(here)
    sys.path.insert(0, here)
    try:
        import hplflownet_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: hplflownet_tpu_torch is not beside this script "
              f"({e})", file=sys.stderr)
        return 2
    # parity on the card runs float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    results: dict = {}
    phases = [("device", phase_device), ("build", phase_build),
              ("kernels", lambda: phase_kernels(results)),
              ("reference", phase_reference),
              ("main path", lambda: phase_main_path(results))]
    outputs = {}
    for i, (name, fn) in enumerate(phases, 1):
        t = time.perf_counter()
        try:
            outputs[name] = fn()
        except Exception:
            traceback.print_exc()
            log(f"phase {i} {name}: FAILED after {time.perf_counter() - t:.1f} s")
            return 1
        log(f"phase {i} {name}: ok in {time.perf_counter() - t:.1f} s")

    kind, smi_line = outputs["device"]
    print(json.dumps(kernels_line(results)), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
