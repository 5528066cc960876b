#!/usr/bin/env python3
"""Smoke run of hplflownet_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing a line with its elapsed seconds:

1. device   the card's name and power limit (nvidia-smi);
2. build    compile every CUDA kernel of the main path with nvcc, in
            parallel, into hplflownet_tpu_torch/_build/, printing ptxas's
            registers, shared memory and spills per kernel;
3. kernels  each kernel against its plain PyTorch version on the card, at
            the shapes the forward and the train step give it, in float32
            and bfloat16: max error, kernel and plain time, the bound, and
            a library yardstick; for the two stencil kernels (through the
            tables' stencil plans) also "gather + matmul" (the spread's
            materialisation with the GEMM), TFLOP/s over present taps, the
            plan's block coverage, reruns bit for bit, and each bf16 target
            against the library call; kernels 2 and 4-7 also give
            ``device_ms``, the mean of a replayed CUDA graph of 20 calls
            (their per-call ``ms`` near 0.05 ms is the wrapper's host
            time), beside the same for their yardstick (``index_add_``,
            index + sum, ``index_select``), with the device-time targets
            of kernels 2, 4, 5 and 7; kernels 2 and 4 run at every shape
            one flagship train step gives them, on the step's own inputs
            (``hplflownet_tpu_torch.tools.step_calls``), with launches
            per step and per forward, the bound and kernel 2's regime
            (kernel 2 bit for bit against kernel 5 there); kernels 2, 5
            and 7 run the edge-case streams of
            ``hplflownet_tpu_torch.tools.rank_cases`` and kernel 4 those
            of ``hplflownet_tpu_torch.tools.tap_cases`` (kernel 5 bit for
            bit against ``rank_reduce`` where the stream is a rank-mode
            plan); nvidia-smi samples SM clock, power and temperature
            meanwhile;
4. dense    ``dense_gemm`` (the dense layers' GEMM with its epilogue) at
            the main path's widest shapes (DENSE_CASES: the head's conv2
            at 98304 rows, bcn1_'s pointwise conv at 90752, a
            correlation's corr1 at h1 x 15 = 314880, the flow head's
            conv4) against its plain version: max error, a rerun bit for
            bit, device ms (a replayed CUDA graph), ms through the
            wrapper, the bound, the plain version's ms and
            ``torch.matmul`` on the bf16 operands;
5. slice    ``slice_points`` (the slice back to points with its bias and
            cast) on the calls of real forwards (SLICE_CASES: SPLATNet3D's
            BCL 3 on a 98304-point cloud, the flagship decoder's finest
            slice at 98304 points and its coarsest at 8192): equal to its
            plain version, a rerun bit for bit, device ms (a replayed CUDA
            graph) beside the bytes bound, the plain composition's device
            ms (which the kernel must beat at every case) and
            ``index_select`` of the rows;
6. reference  the float32 forward through the kernels on a 64-point pair
            against the JAX package's output frozen in
            tests/data/torch_port_ref_n64.npz, and the float32 train step's
            loss and gradients on the same pair against JAX's, frozen in
            tests/data/torch_port_train_ref_n64.npz;
7. main path  one 8192-point pair through ``pipeline.flow_forward`` at full
            width (7 scales, bf16 compute): the launch counts of the
            forward's kernels and its stencil plans (and the CUDA kernels
            one pair's plans launch), the flow's shape and finiteness, zero
            overflow, every kernel call against its plain version on its
            inputs (CALL_TOL; the slice kernel's equal), the same forward
            with the plain versions forced, and pairs/s;
8. train    the flagship train step (``train.step.make_train_step``: the
            8192-point pair, batch 1, bf16, Adam at lr 1e-4, overflow skip):
            the launch counts of all four kernels in one step, every kernel
            call of the step against its plain version on its inputs
            (CALL_TOL; the slice kernel's equal), two gradient
            evaluations bit for bit, the gradients against the same step
            with the plain versions forced (in bf16, and in float32 on a
            float32 copy of the model), and ms/step over timed steps;
9. fused    the same forward and train step under ``HPL_RANK_FUSED=1``
            (the fused rank-mode reduction, ``blocked_rank_reduce``): its
            launch counts per forward and per step (``rank_reduce`` none),
            the flow and gradients against the default route bit for bit,
            ms/pair and ms/step of both routes timed in turns; the
            environment is restored afterwards;
10. shallow  ``HPLFlowNetShallow`` at full width (5 scales, SFM5, bf16,
            the 8192-point pair, capacities SHALLOW_CAPACITIES): a forward
            and a train step with the launch counts of kernels 1-4 and zero
            overflow; every kernel call of the step against its plain
            version on the same inputs (CALL_TOL); the step with the plain
            versions forced (float32 gradients 1e-3; bf16 flow 5e-2, median
            leaf 2e-2, and as close to the float32 gradient as the plain
            bf16 step is, as in the train phase); pairs/s and ms/step; and the
            float32 64-point pair against the frozen JAX reference
            tests/data/torch_port_shallow_ref_n64.npz (the reference phase's limits);
11. driver   ``train.driver.run`` on a synthetic FlyingThings3D-layout
            directory (4 train and 3 val frames of 10240 points): the
            flagship trained one epoch (bf16, batch 2, capacities measured
            on the card), every step free of overflow, a finite loss, a
            ``model_best``, the checkpoint restored bit for bit, then two
            evaluations from it with six finite metrics, bit-identical;
            train and evaluation pairs/s and the seconds from ``run`` to
            its first step, with the kernels' launches in each;
12. tools   the op microbench and the two labs
            (``hplflownet_tpu_torch.tools``) at few reps, and the launch
            counts of ``row_take`` and ``rank_partial`` in them; then the
            lattice build's stages per scale (``tools.pyramid_bench``);
13. bench   ``hplflownet_tpu_torch.bench`` at a few reps: its JSON line
            (pairs/s, train ms/step, launches, the card), kernels 1-4
            launched in its step;
14. synthetic  ``tools.train_synthetic`` (the shallow model, 1024 points, 8
            steps, ``--save-params``), ``tools.eval_synthetic`` on that
            pickle through the driver with the scene dumps, and
            ``data.visualization``'s CLI on them: six finite metrics, zero
            overflow, the .ply and .html files, the rates;
15. large   ``tools.large_cloud_bench`` at 32768 and 98304 points on the
            flagship (bf16, capacities measured on seeds 0-2 with slack
            1.25): zero on all four overflow counters, ms/pair, peak MiB,
            launches of kernels 1 and 2; every kernel call of one 98304-point
            forward against its plain version on its inputs (CALL_TOL); the
            32768-point flow against the forward with the plain versions
            forced (the main path's bound);
16. segment  SPLATNet3D (``pipeline.segment_forward``, bf16, seeded
            weights and BatchNorm statistics) on one 98304-point cloud at
            SEG_CAPACITIES: the launches of kernels 1 and 2 and
            ``dense_gemm`` (5 / 8 / 3: kernel 2 twice where a BCL's splat
            runs are split, ``ops.segment.run_sums``), zero overflow,
            every kernel call against its plain version on its inputs
            (CALL_TOL), kernel 2's parts passes, the K = 960 GEMM and the
            256 -> 256 blurs among them, the logits against the forward
            with the plain versions forced (the main path's bound), ms a cloud;
17. native  the host builder (``hplflownet_tpu_torch.native``, g++) against
            the device builder on the 8192-point pair at scale 1.0: ids,
            unique keys, neighbour and correlation tables equal; host ms;
18. dp      data parallel (``parallel.make_dp_train_step``): two gloo ranks
            on the one card, fresh interpreters started by
            ``tools.dryrun_multiprocess``, take one step of the flagship
            (float32, 8192 points, global batch 2, the second sample's
            valid1 cut to half), held to the single-process step on the
            whole batch (loss 1e-6 relative, each gradient leaf 1e-5 of its
            max, parameters after Adam within tests/test_sharding.py's
            bounds) and to each other bit for bit; then one NCCL rank at
            world size 1, bit for bit against the single-process step on
            one sample; kernels 1-4 launched in every rank, the step's ms
            (after the phases it could slow: it starts NCCL in this process);
19. lattice lattice parallel (``parallel.lattice_sharded_forward``): two
            gloo ranks on the one card (fresh interpreters) run the flagship
            forward (bf16, 8192 points) with the probes split over the taps
            and the blur / correlation vertices over the ranks: the flow
            against the unsharded ``flow_forward`` (bit for bit, else phase
            5's bound), the tap-sharded tables equal, each rank's kernel-1
            calls computing ceil(H / 2) of their H rows, every kernel call
            of each rank's forward (row slices with plans of their own
            columns) against its plain version on its inputs (CALL_TOL);
            ms/pair sharded and unsharded on the host clock (two ranks
            share one card: no scaling figure); then one NCCL rank at
            world size 1, bit for bit;
20. plans   the CUDA kernels that one pair's stencil plans launch
            (torch.profiler; tracing slows the host afterwards);
21. fused_build  ``HPL_FUSED_BUILD`` (both clouds of a scale built from one
            sort and probed in one join): every table of the flagship and
            the shallow model's pyramids for the 8192-point pair under "1"
            and "3584" against "0", the flagship flow and one train step's
            loss and gradients under "1" against "0", all bit for bit, with
            the launches of kernels 1-4; ``pipeline.batched_flow_forward``
            on two pairs with invalid points against per-sample
            ``flow_forward``, bit for bit; then, in a fresh interpreter,
            ``tools.fused_build_bench``: build, forward and step ms with the
            modes in turns, the build's torch operators and the device
            kernels per forward and per step.

Then one JSON line listing every kernel (with its launches on every path
above), the nvidia-smi line, and as the
last line ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before the last line.  ``--phases device,build,kernels`` runs only the
named phases (and prints no kernels line); ``--out f.json`` writes the
phases' results.  Without a CUDA card, or without the package beside
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
# what a forward launches: kernels 1 and 2, the dense layers' kernel and
# the slice kernel; the flagship forward's dense products: conv1 3 x 2
# clouds, the encoder's pointwise convs 7 x 2, the decoder's 7, the
# correlations' 3 x 5, the head's 3; its slices: one a decoder BCL
FORWARD_KERNELS = ("stencil_gather_matmul", "rank_reduce", "dense_gemm",
                   "slice_points")
FLAGSHIP_DENSE = 45
FLAGSHIP_SLICES = 7
REF_NPZ = os.path.join("tests", "data", "torch_port_ref_n64.npz")
TRAIN_REF_NPZ = os.path.join("tests", "data", "torch_port_train_ref_n64.npz")
# the shallow model: tools/train_synthetic.py's 5-scale map; capacities of
# lattice.capacity.measured_default_capacities(8192, SFM5)
SFM5 = [[1.0, 1, 1, 1], [0.5, 1, 1, 1], [0.25, 1, 1, 1],
        [0.125, 1, 1, 1], [0.0625, 1, 1, 1]]
SHALLOW_CAPACITIES = [9472, 3712, 1024, 384, 128]
SHALLOW_REF_NPZ = os.path.join("tests", "data", "torch_port_shallow_ref_n64.npz")
DEVICE = "cuda"   # a CPU rehearsal of the phases may set "cpu" after import
TRAIN_WARMUP, TRAIN_REPS = 2, 5
DIR_SEED = 5      # seeds the directions of the frozen gradient summary
# the tools phase: reps per op, the microbench's width divisor and sort
# sizes, and the rank-partial lab's stream sizes (a CPU rehearsal cuts them)
TOOLS_REPS, TOOLS_WIDTH_DIV = 3, 1
TOOLS_SORT_SIZES = (131072, 425984, 880000)
LAB_SIZES = (128000, 102400)

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
    """Mean device time of ``fn()`` over ``reps`` launches (CUDA events;
    the host clock in a CPU rehearsal)."""
    from hplflownet_tpu_torch.tools.timing import time_ms
    return time_ms(fn, DEVICE, reps, warmup)


GRAPH_CALLS, GRAPH_REPLAYS = 20, 5


def device_ms(fn) -> float:
    """Mean device time of one ``fn()`` call: CUDA events around replays of
    a CUDA graph of GRAPH_CALLS captured calls, so the wrapper's host time
    drops out (the host clock in a CPU rehearsal)."""
    from hplflownet_tpu_torch.tools.timing import graph_ms
    return graph_ms(fn, DEVICE, GRAPH_CALLS, GRAPH_REPLAYS)


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


def grad_summary(grads: dict, names) -> tuple:
    """Per leaf (in ``names`` order): the gradient's L2 norm and its dot
    products with 4 directions of standard normals seeded by (DIR_SEED, i),
    in float64.  Leaves are numpy arrays."""
    import numpy as np
    norms = np.zeros(len(names))
    dots = np.zeros((len(names), 4))
    for i, name in enumerate(names):
        g = np.asarray(grads[name], dtype=np.float64).ravel()
        rng = np.random.default_rng([DIR_SEED, i])
        norms[i] = np.linalg.norm(g)
        for j in range(4):
            dots[i, j] = rng.standard_normal(g.size, dtype=np.float32) @ g
    return norms, dots


# Train step vs the frozen JAX summary: (loss rel, norm rel, dot / norm)
# against JAX as it is, whose float32 segment sums lose ~3e-7 per run that
# 1/(density + 1e-5) amplifies on sparsely hit vertices (up to 2.8e-2 of a
# leaf's max on this case, 1.5e-2 in a dot), and against JAX with exact
# segment sums, which the port matches to ~1e-6.
TRAIN_TOL = {"": (1e-5, 1e-2, 5e-2), "exact_": (1e-5, 1e-4, 1e-3)}


def check_train_reference(ref, loss: float, grads: dict,
                          prefixes=tuple(TRAIN_TOL)) -> list:
    """Hold a float32 train step's loss and gradients (tensors) against the
    frozen JAX summary (``prefixes`` of TRAIN_TOL: "" JAX as it is,
    "exact_" JAX with exact segment sums); raises past TRAIN_TOL.  -> per
    comparison the worst leaf's errors."""
    import numpy as np
    names = [str(n) for n in ref["names"]]
    norms, dots = grad_summary(
        {k: v.detach().float().cpu().numpy() for k, v in grads.items()}, names)
    rows = []
    for prefix in prefixes:
        tol_loss, tol_norm, tol_dot = TRAIN_TOL[prefix]
        want = float(ref[f"{prefix}loss"])
        if not abs(loss - want) <= tol_loss * abs(want):
            raise AssertionError(f"train loss {loss!r} vs JAX {prefix}{want!r}")
        ref_norm = ref[f"{prefix}grad_norm"]
        norm_err = np.abs(norms - ref_norm) / ref_norm
        dot_err = np.abs(dots - ref[f"{prefix}grad_dots"]).max(1) / ref_norm
        bad = [names[i] for i in np.flatnonzero((norm_err > tol_norm)
                                                | (dot_err > tol_dot))]
        if bad:
            raise AssertionError(f"gradients vs JAX {prefix or 'as is'}: "
                                 f"{len(bad)} leaves past tolerance: {bad[:5]}")
        rows.append(dict(against=prefix.rstrip("_") or "jax",
                         worst_norm=float(norm_err.max()),
                         worst_dot=float(dot_err.max())))
    return rows


def plan_kernels(scales) -> dict:
    """CUDA kernels launched by one pair's stencil plans
    (``models.hplflownet.stencil_plans``): the forward's row orders alone
    and the train step's with the vertex lists (None in a CPU rehearsal)."""
    from hplflownet_tpu_torch.models.hplflownet import stencil_plans
    if DEVICE != "cuda":
        return dict(kernels_forward=None, kernels_step=None)
    import torch
    from torch.profiler import ProfilerActivity, profile
    out = {}
    for key, lists in (("kernels_forward", False), ("kernels_step", True)):
        stencil_plans(scales, lists=lists)
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            stencil_plans(scales, lists=lists)
            sync()
        out[key] = int(sum(e.count for e in prof.key_averages()
                           if e.device_type == torch.autograd.DeviceType.CUDA))
    return out


class SmiSampler:
    """``nvidia-smi`` sampling SM clock, power draw and temperature every
    200 ms while a phase runs; ``summary()`` gives each one's range."""

    QUERY = "clocks.sm,clocks.mem,power.draw,power.limit,temperature.gpu"

    def __enter__(self):
        self.proc = None
        if DEVICE == "cuda":
            self.proc = subprocess.Popen(
                ["nvidia-smi", f"--query-gpu={self.QUERY}",
                 "--format=csv,noheader,nounits", "-lms", "200"],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.lines = []
        if self.proc is not None:
            self.proc.terminate()
            try:
                out, _ = self.proc.communicate(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                out, _ = self.proc.communicate()
            self.lines = [ln for ln in out.splitlines() if ln.strip()]
        return False

    def summary(self) -> dict:
        cols = self.QUERY.split(",")
        vals = {c: [] for c in cols}
        for ln in self.lines:
            parts = [x.strip() for x in ln.split(",")]
            for c, x in zip(cols, parts):
                try:
                    vals[c].append(float(x))
                except ValueError:
                    pass
        return {c: [min(v), max(v)] for c, v in vals.items() if v} | {
            "samples": len(self.lines)}


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
                if any(k in ln for k in ("entry function", "registers", "spill"))]
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
                             adjoint_plans=True)


def plan_coverage(nb, h_in, order) -> float:
    """Share of the F x H_out tap-rows a block-skipping kernel computes when
    it takes the rows in ``order``, 128 at a time."""
    from hplflownet_tpu_torch.kernels.stencil_plan import (
        ROW_BLOCK, block_tap_counts, presence)
    f, h = nb.shape
    blocks = block_tap_counts(presence(nb, h_in), order)
    return float(blocks.sum()) * ROW_BLOCK / (f * h)


def _stencil_cases(scales, randn) -> list:
    """stencil_gather_matmul (kernel 1) at every shape of the forward and
    the train step's input gradients, through the tables' stencil plans."""
    import torch
    from hplflownet_tpu_torch.kernels.stencil import (
        stencil_gather_matmul, stencil_gather_matmul_plain)
    from hplflownet_tpu_torch.kernels.stencil_plan import make_stencil_plan
    from hplflownet_tpu_torch.lattice.offsets import tap_negation
    dev = scales[0].pc1_blur_neighbors.device
    neg = torch.tensor(tap_negation(1, 3), device=dev)
    h0, h1, h2 = CAPACITIES[0], CAPACITIES[1], CAPACITIES[2]
    tables = {"s0": (scales[0].pc1_blur_neighbors, h0),
              "s1": (scales[1].pc1_blur_neighbors, h1),
              "s2": (scales[2].pc1_blur_neighbors, h2),
              "self": (scales[2].pc1_corr_indices, h2),
              "cross": (scales[2].pc2_corr_uniq, h2)}
    plans = {k: make_stencil_plan(nb, h, lists=False)
             for k, (nb, h) in tables.items()}
    # name, table key, negated taps, C_in, C_out, act slope, output dtype,
    # bias: as the main path calls the kernel
    cases = [
        ("bcn1 blur", "s0", False, 68, 64, 0.1, "compute", True),
        ("bcn1_ decoder blur", "s0", False, 580, 1024, 0.1, "compute", True),
        ("bcn2_ decoder blur", "s1", False, 324, 512, 0.1, "compute", True),
        ("bcn3_ decoder blur", "s2", False, 388, 256, 0.1, "compute", True),
        ("corr_self", "self", False, 128, 32, None, "float32", True),
        ("corr_cross", "cross", False, 64, 480, None, "float32", False),
        # the decoder blur's input gradient: negated taps, transposed
        # kernel, the forward's row order
        ("bcn1_ blur input gradient", "s0", True, 1024, 580, None, "compute",
         False),
    ]
    rows = []
    for name, key, negated, c_in, c_out, slope, out_kind, has_bias in cases:
        nb, h_in = tables[key]
        nb = (nb[neg] if negated else nb).contiguous()
        plan = plans[key]
        order = plan.order
        f, h_out = nb.shape
        nnz = int(((nb >= 0) & (nb < h_in)).sum())
        cover = plan_coverage(nb, h_in, order)
        natural = plan_coverage(nb, h_in, torch.arange(
            h_out, dtype=torch.int32, device=dev))
        table32 = randn(h_in, c_in)
        w32 = randn(f, c_in, c_out, scale=(2.0 / (f * (c_in + c_out))) ** 0.5)
        bias = randn(c_out, scale=0.1)
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            table, w = table32.to(dt), w32.to(dt)
            out_dt = dt if out_kind == "compute" else torch.float32
            b = bias if has_bias else None

            def kern():
                return stencil_gather_matmul(table, nb, w, bias=b,
                                             act_slope=slope, out_dtype=out_dt,
                                             plan=plan)
            got = kern()
            again = kern()
            want = stencil_gather_matmul_plain(table, nb, w, bias=b,
                                               act_slope=slope, out_dtype=out_dt)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"stencil {name} {dtn}: rerun differs")
            # float32 sums differ only in order (K = F * C_in terms); a
            # bf16 output may then round one bf16 ulp (2^-8) either way
            atol, rtol = ((1e-3, 1e-4) if out_dt == torch.float32
                          else (1e-2, 1e-2))
            err = max_err(got, want, atol, rtol, f"stencil {name} {dtn}")
            ms = cuda_ms(kern)
            plain_ms = cuda_ms(lambda: stencil_gather_matmul_plain(
                table, nb, w, bias=b, act_slope=slope, out_dtype=out_dt), reps=3)
            pad = torch.cat([table.new_zeros(1, c_in), table])
            idx = (nb.t() + 1).long()
            wm = w.reshape(f * c_in, c_out)
            spread = pad[idx].reshape(h_out, f * c_in)
            lib_ms = cuda_ms(lambda: torch.matmul(spread, wm))
            del spread
            gm_ms = cuda_ms(lambda: torch.matmul(
                pad[idx].reshape(h_out, f * c_in), wm))
            s_in, s_out = table.element_size(), got.element_size()
            nbytes = (table.numel() * s_in + nb.numel() * 4 + w.numel() * s_in
                      + got.numel() * s_out + (c_out * 4 if b is not None else 0))
            flops = 2.0 * nnz * c_in * c_out
            bms, by = bound_ms(nbytes, flops, dtn)
            row = dict(case=name, dtype=dtn,
                       shape=f"H={h_out} F={f} C_in={c_in} C_out={c_out}",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms, gather_matmul_ms=gm_ms,
                       tflops=flops / ms / 1e9, present=nnz / (f * h_out),
                       coverage=cover, coverage_natural=natural)
            rows.append(row)
            log(f"stencil_gather_matmul {name} {dtn} [{row['shape']}]: "
                f"max_abs_err {err:.3e} (atol {atol} rtol {rtol}), rerun "
                f"bit-identical; kernel {ms:.4f} ms ({row['tflops']:.1f} TFLOP/s "
                f"over present taps), plain {plain_ms:.4f} ms, matmul over the "
                f"spread {lib_ms:.4f} ms, gather + matmul {gm_ms:.4f} ms, bound "
                f"{bms:.4f} ms ({by}); present taps {row['present']:.3f}, plan "
                f"block coverage {cover:.3f} (natural order {natural:.3f})")
    return rows


def phase_kernels(results):
    import torch
    from hplflownet_tpu_torch.kernels.splat import (rank_reduce, rank_reduce_plain,
                                                    rank_reduce_regime)
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    scales = _lattice_case_tables(dev)

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device=dev) * scale

    stencil_rows = _stencil_cases(scales, randn)

    # the splat streams at scale 2 (the 127k x 68 case) and scale 0, and
    # the decoder's slice adjoint (the 1024-wide cotangent, no density)
    reduce_rows = []
    for name, si, n_pts, c, with_w in (
            ("scale-2 splat (bcn3)", 2, CAPACITIES[1], 68, True),
            ("scale-0 splat (bcn1)", 0, NUM_POINTS, 68, True),
            ("bcn1_ slice adjoint", 0, NUM_POINTS, 1024, False)):
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
            got = rank_reduce(g, rid, plan.start, plan.end, c, with_w)
            again = rank_reduce(g, rid, plan.start, plan.end, c, with_w)
            want = rank_reduce_plain(g, rid, plan.start, plan.end, c, with_w)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"rank_reduce {name} {dtn}: rerun differs")
            # float32 run sums of a few bf16/f32 products vs the float64 prefix
            err = max_err(got, want, 1e-4, 1e-5, f"rank_reduce {name} {dtn}")
            ms = cuda_ms(lambda: rank_reduce(g, rid, plan.start, plan.end, c, with_w))
            dms = device_ms(lambda: rank_reduce(g, rid, plan.start, plan.end, c,
                                                with_w))
            plain_ms = cuda_ms(lambda: rank_reduce_plain(
                g, rid, plan.start, plan.end, c, with_w), reps=3)
            # yardstick: index_add_ of the already-weighted stream by vertex id
            w_sel = torch.gather(g[:, c:], 1, rid.long()[:, None])
            sv = g[:, :c] * w_sel
            if with_w:
                sv = torch.cat([sv, w_sel], 1)
            sv = sv.float()
            ids = plan.ids[perm].long()
            keep = ids >= 0
            sv, ids = sv[keep].contiguous(), ids[keep].contiguous()
            t_out = plan.start.shape[0]
            lib_ms, lib_dms = _index_add_ms(sv, ids, t_out, dev)
            nbytes = (entries * g.shape[1] * g.element_size() + entries * 4
                      + 2 * t_out * 4 + got.numel() * 4)
            flops = 2.0 * entries * got.shape[1]
            bms, by = bound_ms(nbytes, flops, "float32")
            row = dict(case=name, dtype=dtn,
                       shape=f"M={g.shape[0]} C={c} R={r} T={t_out}",
                       max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms,
                       library_device_ms=lib_dms,
                       regime=rank_reduce_regime(g, rid, plan.start, c, with_w))
            reduce_rows.append(row)
            log(f"rank_reduce {name} {dtn} [{row['shape']}]: max_abs_err "
                f"{err:.3e} (atol 1e-4 rtol 1e-5), rerun bit-identical; kernel "
                f"{ms:.4f} ms per call, {dms:.4f} ms device, plain {plain_ms:.4f} "
                f"ms, index_add_ {lib_ms:.4f} ms per call, {lib_dms:.4f} ms "
                f"device, bound {bms:.4f} ms ({by}); regime {row['regime']}")
    reduce_rows.extend(_plain_row_cases(scales, randn))
    results["dkernel"] = _dkernel_cases(scales, randn)
    results["tap_tables"] = _tap_tables_cases(scales, randn)
    results["stencil"] = stencil_rows
    results["reduce"] = reduce_rows
    results["fused"] = _fused_cases(scales, randn)
    results["take"] = _take_cases(scales, gen)
    results["partial"] = _partial_cases(gen)
    results["reduce_step"], results["tap_step"] = _step_cases()
    results["reduce_edge"] = _reduce_edge_cases(dev)
    results["tap_edge"] = _tap_edge_cases(dev)
    results["targets"] = target_rows(results)
    results["rank_targets"] = rank_target_rows(results)
    log(f"device_ms of kernels 2 and 4-7 and of their yardsticks: a CUDA "
        f"graph of {GRAPH_CALLS} calls, {GRAPH_REPLAYS} replays")
    for t in results["targets"]:
        log(f"target {t['case']} (bf16): kernel {t['ms']:.4f} ms vs "
            f"{t['factor']:g} x library {t['library_ms']:.4f} ms: "
            f"{'met' if t['met'] else 'MISSED'}")
    for t in results["rank_targets"]:
        log(f"target {t['kernel']} {t['case']} {t['dtype']}: device_ms "
            f"{t['device_ms']:.4f} vs {t['factor']:g} x {t['against']} "
            f"{t['yardstick_ms']:.4f} ms: {'met' if t['met'] else 'MISSED'}")
    for kind, name in (("reduce_step", "rank_reduce"),
                       ("tap_step", "stencil_tap_tables_sum")):
        rows = results[kind]
        log(f"{name} over one train step: {sum(r['launches'] for r in rows)} "
            f"launches ({sum(r['launches_forward'] for r in rows)} in the "
            f"forward) at {len(rows)} shapes, "
            f"{sum(r['launches'] * r['device_ms'] for r in rows):.4f} ms "
            f"device, {sum(r['launches'] * r['bound_ms'] for r in rows):.4f} "
            f"ms bound")


# the dense layers' kernel at the main path's widest shapes (98304 points:
# capacities [90752, 72448, 20992, ...]): name, M, K, N, act_slope, out dtype
DENSE_CASES = (("conv2 head", 98304, 1024, 1024, 0.1, "bfloat16"),
               ("bcn1_ conv1", 90752, 1024, 1024, None, "bfloat16"),
               ("corr1 h1 x 15", 20992 * 15, 32, 32, 0.1, "bfloat16"),
               ("conv4 head", 98304, 512, 3, None, "float32"),
               ("conv1.0", 98304, 3, 32, 0.1, "bfloat16"))


def phase_dense(results):
    """``dense_gemm`` (csrc/dense_gemm.cu) at DENSE_CASES against its plain
    version: max error, a rerun bit for bit, kernel ms (host clock through
    the wrapper) and device ms (a replayed CUDA graph), the bound, the plain
    version's ms and ``torch.matmul`` on the bf16 operands (the library
    yardstick, float32 products summed by cuBLAS, no epilogue)."""
    import torch
    from hplflownet_tpu_torch.kernels.dense import dense_gemm, dense_gemm_plain
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = []
    for name, m, k, n, slope, out_name in DENSE_CASES:
        out_dt = getattr(torch, out_name)
        x = torch.randn(m, k, generator=gen, device=dev).to(torch.bfloat16)
        w = torch.randn(k, n, generator=gen, device=dev) / k ** 0.5
        b = torch.randn(n, generator=gen, device=dev) * 0.1

        def run():
            return dense_gemm(x, w, b, slope, out_dt)
        got, again = run(), run()
        want = dense_gemm_plain(x, w, b, slope, out_dt)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"dense_gemm {name}: rerun differs")
        # an ulp of the bf16 output, or the float32 sums' order
        tol = CALL_TOL["bf16" if out_dt == torch.bfloat16 else "f32"]
        err = max_err(got, want, tol * float(want.float().abs().max()), 0.0,
                      f"dense_gemm {name}")
        wb = w.to(torch.bfloat16)
        nbytes = 2 * (m * k + k * n) + 4 * n + m * n * got.element_size()
        bms, by = bound_ms(nbytes, 2.0 * m * k * n, "bfloat16")
        row = dict(case=name, dtype="bfloat16", shape=f"{m} x {k} -> {n}",
                   out=out_name, max_abs_err=err,
                   ms=cuda_ms(run), device_ms=device_ms(run), bound_ms=bms,
                   bound_by=by, plain_ms=cuda_ms(
                       lambda: dense_gemm_plain(x, w, b, slope, out_dt), reps=3),
                   library_ms=cuda_ms(lambda: torch.matmul(x, wb)),
                   library_device_ms=device_ms(lambda: torch.matmul(x, wb)))
        rows.append(row)
        log(f"dense_gemm {name} ({row['shape']}, {out_name} out): device "
            f"{row['device_ms']:.4f} ms ({row['ms']:.4f} through the wrapper), "
            f"bound {bms:.4f} ms by {by} ({100 * bms / row['device_ms']:.1f}%), "
            f"plain {row['plain_ms']:.4f}, torch.matmul bf16 "
            f"{row['library_device_ms']:.4f} ms; max|err| {err:.3e}")
    results["dense"] = rows
    return rows


def _index_add_ms(sv, ids, n_out, dev) -> tuple:
    """Yardstick: one ``index_add_`` of the rows of ``sv`` by ``ids`` into
    zeros.  -> (ms per call, device_ms), timed as the kernels are."""
    import torch
    sv, ids = sv.float().contiguous(), ids.long().contiguous()

    def call():
        return torch.zeros(n_out, sv.shape[1], device=dev).index_add_(0, ids, sv)
    return cuda_ms(call), device_ms(call)


def rank_target_rows(results) -> list:
    """The device-time targets of kernels 2, 4, 5 and 7, each against a
    yardstick timed the same way (a replayed CUDA graph) or a bound:
    kernel 5's main rows within ``index_add_`` and 1.25 x ``rank_reduce``
    on the same stream; kernel 7 within ``index_add_`` at every bo, and bo
    32 within 2 x bo 8; kernel 2 at the bf16 scale-2 splat within 0.017 ms
    and 1.1 x kernel 5 on the same stream, at the bf16 ``bcn1_`` slice
    adjoint within 1.4 x its bound; kernel 4 at the bf16 corr1 adjoint
    within 2 x its bound."""
    out = []

    def add(kernel, row, against, yard, factor, dms=None):
        dms = row["device_ms"] if dms is None else dms
        out.append(dict(kernel=kernel, case=row["case"], dtype=row["dtype"],
                        device_ms=dms, against=against, yardstick_ms=yard,
                        factor=factor, met=dms <= factor * yard))
    for row in results["fused"]:
        if "library_device_ms" in row:
            add("blocked_rank_reduce", row, "index_add_",
                row["library_device_ms"], 1.0)
            add("blocked_rank_reduce", row, "rank_reduce",
                row["rank_reduce_device_ms"], 1.25)
    lab = {(r["case"], r["dtype"]): r for r in results["partial"]
           if r["case"].startswith("lab bo=")}
    for (case, dtn), row in lab.items():
        add("rank_partial", row, "index_add_", row["library_device_ms"], 1.0)
        if case == "lab bo=32" and ("lab bo=8", dtn) in lab:
            add("rank_partial", row, "bo=8", lab[("lab bo=8", dtn)]["device_ms"],
                2.0)

    def bf16(kind, case):
        return [r for r in results[kind]
                if r["case"] == case and r["dtype"] == "bfloat16"][0]
    splat = bf16("reduce", "scale-2 splat (bcn3)")
    add("rank_reduce", splat, "0.017 ms", 0.017, 1.0)
    fused = bf16("fused", "scale-2 splat (bcn3)")
    add("rank_reduce", fused, "blocked_rank_reduce", fused["device_ms"], 1.1,
        dms=fused["rank_reduce_device_ms"])
    wide = bf16("reduce", "bcn1_ slice adjoint")
    add("rank_reduce", wide, "bound", wide["bound_ms"], 1.4)
    tap = bf16("tap_tables", "corr1 adjoint")
    add("stencil_tap_tables_sum", tap, "bound", tap["bound_ms"], 2.0)
    return out


def _plain_row_cases(scales, randn) -> list:
    """``rank_reduce``'s plain-row mode (R = 0) at the ``gather_rows``
    adjoint of scale 2: the (15 x H2, 64) cotangent reduced by vertex."""
    import torch
    from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
    from hplflownet_tpu_torch.ops.segment import make_reduce_plan
    idx = scales[2].pc1_corr_indices
    h2, c = CAPACITIES[2], 64
    plan = make_reduce_plan(idx, h2)
    entries = int((plan.end - plan.start).clamp(min=0).sum())
    cot32 = randn(idx.numel(), c)
    rows = []
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        g = cot32.to(dt)[plan.perm.long()].contiguous()
        got = rank_reduce(g, None, plan.start, plan.end, c)
        again = rank_reduce(g, None, plan.start, plan.end, c)
        want = rank_reduce_plain(g, None, plan.start, plan.end, c)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"rank_reduce R = 0 {dtn}: rerun differs")
        err = max_err(got, want, 1e-4, 1e-5, f"rank_reduce R = 0 {dtn}")
        ms = cuda_ms(lambda: rank_reduce(g, None, plan.start, plan.end, c))
        dms = device_ms(lambda: rank_reduce(g, None, plan.start, plan.end, c))
        plain_ms = cuda_ms(lambda: rank_reduce_plain(
            g, None, plan.start, plan.end, c), reps=3)
        keep = plan.ids >= 0
        lib_ms, lib_dms = _index_add_ms(cot32.to(dt)[keep], plan.ids[keep], h2,
                                        g.device)
        nbytes = entries * c * g.element_size() + 2 * h2 * 4 + got.numel() * 4
        bms, by = bound_ms(nbytes, float(entries * c), "float32")
        row = dict(case="gather_rows adjoint R=0", dtype=dtn,
                   shape=f"M={g.shape[0]} C={c} R=0 T={h2}", max_abs_err=err,
                   ms=ms, device_ms=dms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms, library_device_ms=lib_dms)
        rows.append(row)
        log(f"rank_reduce gather_rows adjoint (R = 0) {dtn} [{row['shape']}]: "
            f"max_abs_err {err:.3e} (atol 1e-4 rtol 1e-5), rerun bit-identical; "
            f"kernel {ms:.4f} ms per call, {dms:.4f} ms device, plain "
            f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms per call, "
            f"{lib_dms:.4f} ms device, bound {bms:.4f} ms ({by})")
    return rows


def _fused_check(name, dtn, g, meta, start_rows, c, r, with_w, t, runs):
    """``blocked_rank_reduce`` (kernel 5) on one stream: a rerun bit for
    bit, the padding rows zero, the plain version within atol 1e-4 + rtol
    1e-5, and, where ``runs`` gives the same stream's rank-mode runs (rid,
    start, end), ``rank_reduce`` bit for bit.  -> (output, max abs error)"""
    import torch
    from hplflownet_tpu_torch.kernels.rank_fused import (
        blocked_rank_reduce, blocked_rank_reduce_plain)
    from hplflownet_tpu_torch.kernels.splat import rank_reduce
    what = f"blocked_rank_reduce {name} {dtn}"
    got = blocked_rank_reduce(g, meta, start_rows, c, r, with_w)
    again = blocked_rank_reduce(g, meta, start_rows, c, r, with_w)
    want = blocked_rank_reduce_plain(g, meta, start_rows, c, r, with_w)
    other = rank_reduce(g, *runs, c, with_w) if runs is not None else None
    sync()
    if not torch.equal(got, again):
        raise AssertionError(f"{what}: rerun differs")
    if other is not None and not torch.equal(got[:t], other):
        raise AssertionError(f"{what}: not bit-equal to rank_reduce")
    if bool(got[t:].any()):
        raise AssertionError(f"{what}: padding rows not zero")
    # float32 run sums of a few bf16/f32 products vs the float64 prefix
    return got, max_err(got, want, 1e-4, 1e-5, what)


def _fused_cases(scales, randn) -> list:
    """``blocked_rank_reduce`` (kernel 5) at the fused route's shapes: the
    scale-2 splat with densities, the decoder's slice adjoint, and plain
    rows (R = 0); each against its plain version and, bit for bit, against
    ``rank_reduce`` on the same stream; then the edge cases of
    ``tools.rank_cases`` (long runs, empty blocks, unordered and
    out-of-range entries, odd pitches, R 0-4)."""
    import torch
    from hplflownet_tpu_torch.kernels.rank_fused import (
        blocked_rank_reduce, blocked_rank_reduce_plain)
    from hplflownet_tpu_torch.kernels.splat import rank_reduce
    from hplflownet_tpu_torch.ops.segment import rank_fused_args
    from hplflownet_tpu_torch.tools.rank_cases import fused_cases, to_torch
    rows = []
    for name, si, n_pts, c, with_w, weighted in (
            ("scale-2 splat (bcn3)", 2, CAPACITIES[1], 68, True, True),
            ("bcn1_ slice adjoint", 0, NUM_POINTS, 1024, False, True),
            ("scale-2 plain rows R=0", 2, CAPACITIES[1], 64, False, False)):
        sp = scales[si]
        plan = sp.pc1_splat_plan
        r = sp.pc1_barycentric.shape[1]
        perm = plan.perm.long()
        rid = (perm % r).to(torch.int32)
        meta, start_rows = rank_fused_args(plan, rid if weighted else None)
        r_k = r if weighted else 0
        t = plan.start.shape[0]
        entries = int((plan.end - plan.start).clamp(min=0).sum())
        feats32 = randn(n_pts, c)
        runs = (rid if weighted else None, plan.start, plan.end)
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            src = feats32.to(dt)
            if weighted:
                src = torch.cat([src, sp.pc1_barycentric.to(dt)], 1)
            g = src[perm // r].contiguous()
            got, err = _fused_check(name, dtn, g, meta, start_rows, c, r_k,
                                    with_w, t, runs)

            def kern():
                return blocked_rank_reduce(g, meta, start_rows, c, r_k, with_w)
            ms, dms = cuda_ms(kern), device_ms(kern)
            rr_dms = device_ms(lambda: rank_reduce(g, *runs, c, with_w))
            plain_ms = cuda_ms(lambda: blocked_rank_reduce_plain(
                g, meta, start_rows, c, r_k, with_w), reps=3)
            if weighted:
                w_sel = torch.gather(g[:, c:], 1, rid.long()[:, None])
                sv = g[:, :c] * w_sel
                sv = torch.cat([sv, w_sel], 1) if with_w else sv
            else:
                sv = g
            ids = plan.ids[perm]
            keep = ids >= 0
            lib_ms, lib_dms = _index_add_ms(sv[keep], ids[keep], t, g.device)
            nbytes = (entries * g.shape[1] * g.element_size() + g.shape[0] * 4
                      + start_rows.numel() * 4 + got.numel() * 4)
            flops = (2.0 if weighted else 1.0) * entries * got.shape[1]
            bms, by = bound_ms(nbytes, flops, "float32")
            row = dict(case=name, dtype=dtn,
                       shape=f"M={g.shape[0]} C={c} R={r_k} T={t}",
                       max_abs_err=err, ms=ms, device_ms=dms, plain_ms=plain_ms,
                       bound_ms=bms, bound_by=by, library_ms=lib_ms,
                       library_device_ms=lib_dms, rank_reduce_device_ms=rr_dms)
            rows.append(row)
            log(f"blocked_rank_reduce {name} {dtn} [{row['shape']}]: max_abs_err "
                f"{err:.3e} (atol 1e-4 rtol 1e-5), rerun and rank_reduce "
                f"bit-identical; kernel {ms:.4f} ms per call, {dms:.4f} ms "
                f"device (rank_reduce {rr_dms:.4f} ms device), plain "
                f"{plain_ms:.4f} ms, index_add_ {lib_ms:.4f} ms per call, "
                f"{lib_dms:.4f} ms device, bound {bms:.4f} ms ({by})")
    dev = scales[0].pc1_blur_neighbors.device
    for case in fused_cases():
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            a = to_torch(case, dt, dev)
            runs = ((a.get("rid"), a["start"], a["end"]) if case.rank_mode
                    else None)
            got, err = _fused_check(f"edge {case.name}", dtn, a["g"], a["meta"],
                                    a["start_rows"], case.c, case.r,
                                    case.with_weights, case.t, runs)

            def kern():
                return blocked_rank_reduce(a["g"], a["meta"], a["start_rows"],
                                           case.c, case.r, case.with_weights)
            ms, dms = cuda_ms(kern), device_ms(kern)
            g = a["g"]
            nbytes = (g.numel() * g.element_size() + g.shape[0] * 4
                      + a["start_rows"].numel() * 4 + got.numel() * 4)
            bms, by = bound_ms(nbytes, 2.0 * g.shape[0] * got.shape[1], "float32")
            row = dict(case=f"edge {case.name}", dtype=dtn,
                       shape=f"M={g.shape[0]} C={case.c} R={case.r} T={case.t}",
                       max_abs_err=err, ms=ms, device_ms=dms, bound_ms=bms,
                       bound_by=by, rank_reduce_equal=runs is not None)
            rows.append(row)
            log(f"blocked_rank_reduce edge {case.name} {dtn} [{row['shape']}]: "
                f"max_abs_err {err:.3e} (atol 1e-4 rtol 1e-5), rerun "
                + ("and rank_reduce " if runs is not None else "")
                + f"bit-identical; kernel {ms:.4f} ms per call, {dms:.4f} ms "
                f"device, bound {bms:.4f} ms ({by})")
    return rows


def _take_cases(scales, gen) -> list:
    """``row_take`` (kernel 6) at the gather lab's shape: one tap of scale
    0's neighbour table over a (H + 1, 128) table."""
    import torch
    from hplflownet_tpu_torch.kernels.take import row_take, row_take_plain
    nb = scales[0].pc1_blur_neighbors
    h = nb.shape[1]
    dev = nb.device
    idx = (nb[3] + 1).contiguous()
    idx64 = idx.long()
    rows = []
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        table = torch.randn(h + 1, 128, generator=gen, device=dev).to(dt)
        got = row_take(table, idx)
        want = row_take_plain(table, idx)
        sync()
        if not torch.equal(got, want):
            raise AssertionError(f"row_take {dtn}: differs from the plain version")
        ms = cuda_ms(lambda: row_take(table, idx))
        dms = device_ms(lambda: row_take(table, idx))
        plain_ms = cuda_ms(lambda: row_take_plain(table, idx), reps=3)
        lib_ms = cuda_ms(lambda: table.index_select(0, idx64))
        lib_dms = device_ms(lambda: table.index_select(0, idx64))
        nbytes = 2 * h * 128 * table.element_size() + h * 4
        bms, by = bound_ms(nbytes, 0.0, "float32")
        row = dict(case="gather lab take", dtype=dtn, shape=f"H={h} C=128",
                   max_abs_err=0.0, ms=ms, device_ms=dms, plain_ms=plain_ms,
                   bound_ms=bms, bound_by=by, library_ms=lib_ms,
                   library_device_ms=lib_dms)
        rows.append(row)
        log(f"row_take {dtn} [{row['shape']}]: equal to index_select; kernel "
            f"{ms:.4f} ms per call, {dms:.4f} ms device, plain {plain_ms:.4f} "
            f"ms, index_select {lib_ms:.4f} ms per call, {lib_dms:.4f} ms "
            f"device, bound {bms:.4f} ms ({by})")
    return rows


def _partial_check(name, g, meta, c, r, with_w, out_dt, bo=8):
    """``rank_partial`` (kernel 7) on one stream: a rerun bit for bit and
    the plain version within tolerance.  -> (output, max abs error)"""
    import torch
    from hplflownet_tpu_torch.kernels.rank_partial import (rank_partial,
                                                           rank_partial_plain)
    got = rank_partial(g, meta, c, r, with_w, bo=bo, out_dtype=out_dt)
    again = rank_partial(g, meta, c, r, with_w, bo=bo, out_dtype=out_dt)
    want = rank_partial_plain(g, meta, c, r, with_w, out_dtype=out_dt)
    sync()
    if not torch.equal(got, again):
        raise AssertionError(f"rank_partial {name}: rerun differs")
    # float32 sums of products in stream order vs float64; a bf16 output may
    # then round one bf16 ulp (2^-8) apart
    atol, rtol = (1e-4, 1e-5) if out_dt == torch.float32 else (1e-4, 8e-3)
    return got, max_err(got, want, atol, rtol, f"rank_partial {name}")


def _partial_cases(gen) -> list:
    """``rank_partial`` (kernel 7) on the rank-partial lab's M = 128000
    stream (bf16, C 68, R 4, densities), float32 and bf16 output, at 8, 16
    and 32 blocks per CTA; then the edge cases of ``tools.rank_cases``
    (local ranks >= 128, lanes outside [0, R), odd pitches, R 0-4)."""
    import torch
    from hplflownet_tpu_torch.kernels.rank_partial import (rank_partial,
                                                           rank_partial_plain)
    from hplflownet_tpu_torch.tools.rank_cases import partial_cases, to_torch
    from hplflownet_tpu_torch.tools.rank_partial_lab import lab_stream
    m, c, r = LAB_SIZES[0], 68, 4
    g, meta, _, lane = lab_stream(m, c, r, gen, torch.device(DEVICE))
    pos = torch.arange(m, device=g.device)
    key = pos - pos % 128 + (meta & 0xFFFF).long()
    w_sel = torch.gather(g[:, c:], 1, lane.long()[:, None])
    sv = torch.cat([g[:, :c] * w_sel, w_sel], 1)
    rows = []
    for bo in (8, 16, 32):
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            got, err = _partial_check(f"bo={bo} {dtn}-out", g, meta, c, r, True,
                                      dt, bo)

            def kern():
                return rank_partial(g, meta, c, r, True, bo=bo, out_dtype=dt)
            ms, dms = cuda_ms(kern), device_ms(kern)
            plain_ms = (cuda_ms(lambda: rank_partial_plain(
                g, meta, c, r, True, out_dtype=dt), reps=3) if bo == 8 else None)
            lib_ms, lib_dms = _index_add_ms(sv, key, got.shape[0], g.device)
            nbytes = (g.numel() * g.element_size() + m * 4
                      + got.numel() * got.element_size())
            bms, by = bound_ms(nbytes, 2.0 * m * (c + 1), "float32")
            row = dict(case=f"lab bo={bo}", dtype=dtn,
                       shape=f"M={m} C={c} R={r} out {dtn}", max_abs_err=err,
                       ms=ms, device_ms=dms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms, library_device_ms=lib_dms)
            rows.append(row)
            log(f"rank_partial lab bo={bo} {dtn}-out [{row['shape']}]: max_abs_err "
                f"{err:.3e}, rerun bit-identical; kernel {ms:.4f} ms per call, "
                f"{dms:.4f} ms device, "
                + (f"plain {plain_ms:.4f} ms, " if plain_ms is not None else "")
                + f"index_add_ {lib_ms:.4f} ms per call, {lib_dms:.4f} ms device, "
                f"bound {bms:.4f} ms ({by})")
    for case in partial_cases():
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            a = to_torch(case, dt, g.device)
            name = f"edge {case.name}"
            got, err = _partial_check(f"{name} {dtn}", a["g"], a["meta"], case.c,
                                      case.r, case.with_weights, dt)

            def kern():
                return rank_partial(a["g"], a["meta"], case.c, case.r,
                                    case.with_weights, out_dtype=dt)
            ms, dms = cuda_ms(kern), device_ms(kern)
            ge = a["g"]
            nbytes = (ge.numel() * ge.element_size() + ge.shape[0] * 4
                      + got.numel() * got.element_size())
            bms, by = bound_ms(nbytes, 2.0 * ge.shape[0] * got.shape[1], "float32")
            row = dict(case=name, dtype=dtn, shape=f"M={ge.shape[0]} C={case.c} "
                       f"R={case.r} {dtn} in and out", max_abs_err=err, ms=ms,
                       device_ms=dms, bound_ms=bms, bound_by=by)
            rows.append(row)
            log(f"rank_partial {name} {dtn} [{row['shape']}]: max_abs_err "
                f"{err:.3e}, rerun bit-identical; kernel {ms:.4f} ms per call, "
                f"{dms:.4f} ms device, bound {bms:.4f} ms ({by})")
    return rows


def _dkernel_cases(scales, randn) -> list:
    """stencil_dkernel (kernel 3) at the train step's weight-gradient shapes
    (the decoder blurs at scales 0-2, both correlations), through the
    tables' stencil plans."""
    import torch
    from hplflownet_tpu_torch.kernels.dkernel import (stencil_dkernel,
                                                      stencil_dkernel_plain,
                                                      vertex_splits)
    from hplflownet_tpu_torch.kernels.stencil_plan import make_stencil_plan
    h0, h1, h2 = CAPACITIES[0], CAPACITIES[1], CAPACITIES[2]
    cases = [("bcn1_ blur dW", scales[0].pc1_blur_neighbors, h0, 580, 1024),
             ("bcn2_ blur dW", scales[1].pc1_blur_neighbors, h1, 324, 512),
             ("bcn3_ blur dW", scales[2].pc1_blur_neighbors, h2, 388, 256),
             ("corr_self dW", scales[2].pc1_corr_indices, h2, 128, 32),
             ("corr_cross dW", scales[2].pc2_corr_uniq, h2, 64, 480)]
    rows = []
    for name, nb, h_in, c_in, c_out in cases:
        nb = nb.contiguous()
        f, h_out = nb.shape
        plan = make_stencil_plan(nb, h_in)
        nnz = int(plan.counts.sum())
        splits, chunk = vertex_splits(f, c_in, c_out, h_out)
        table32, g32 = randn(h_in, c_in), randn(h_out, c_out)
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            table, g = table32.to(dt), g32.to(dt)
            got = stencil_dkernel(table, nb, g, plan)
            again = stencil_dkernel(table, nb, g, plan)
            want = stencil_dkernel_plain(table, nb, g)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"stencil_dkernel {name} {dtn}: rerun differs")
            # float32 sums over up to H_out exact products, in another
            # order: 2e-4 of the largest entry
            atol = 2e-4 * float(want.abs().max())
            err = max_err(got, want, atol, 0.0, f"stencil_dkernel {name} {dtn}")
            ms = cuda_ms(lambda: stencil_dkernel(table, nb, g, plan))
            plain_ms = cuda_ms(lambda: stencil_dkernel_plain(table, nb, g), reps=3)
            pad = torch.cat([table.new_zeros(1, c_in), table])
            idx = (nb + 1).long()
            g_b = g.expand(f, h_out, c_out)
            spread_t = pad[idx].transpose(1, 2)                  # (F, C_in, H_out)
            lib_ms = cuda_ms(lambda: torch.bmm(spread_t, g_b))
            del spread_t
            gm_ms = cuda_ms(lambda: torch.bmm(pad[idx].transpose(1, 2), g_b))
            s_in = table.element_size()
            nbytes = (table.numel() * s_in + nb.numel() * 4 + g.numel() * s_in
                      + got.numel() * 4)
            flops = 2.0 * nnz * c_in * c_out
            bms, by = bound_ms(nbytes, flops, dtn)
            row = dict(case=name, dtype=dtn,
                       shape=f"H={h_out} F={f} C_in={c_in} C_out={c_out}",
                       max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                       bound_by=by, library_ms=lib_ms, gather_matmul_ms=gm_ms,
                       tflops=flops / ms / 1e9, present=nnz / (f * h_out),
                       splits=splits, chunk=chunk)
            rows.append(row)
            log(f"stencil_dkernel {name} {dtn} [{row['shape']}]: max_abs_err "
                f"{err:.3e} (atol {atol:.2e}), rerun bit-identical; kernel "
                f"{ms:.4f} ms ({row['tflops']:.1f} TFLOP/s over present taps), "
                f"plain {plain_ms:.4f} ms, bmm over the spread {lib_ms:.4f} ms, "
                f"gather + bmm {gm_ms:.4f} ms, bound {bms:.4f} ms ({by}); "
                f"present taps {row['present']:.3f}, {splits} chunk(s) of {chunk}")
    return rows


# (kind, case) -> the yardstick it must meet: no slower than the library
# call at bcn1_, within 2x of it at the correlations
TARGETS = (("stencil", "bcn1_ decoder blur", 1.0),
           ("stencil", "bcn1_ blur input gradient", 1.0),
           ("dkernel", "bcn1_ blur dW", 1.0),
           ("stencil", "corr_self", 2.0), ("stencil", "corr_cross", 2.0),
           ("dkernel", "corr_self dW", 2.0), ("dkernel", "corr_cross dW", 2.0))


def target_rows(results) -> list:
    """Each bf16 target case: kernel ms against its library call's."""
    out = []
    for kind, case, factor in TARGETS:
        row = [r for r in results[kind]
               if r["case"] == case and r["dtype"] == "bfloat16"][0]
        out.append(dict(kind=kind, case=case, ms=row["ms"],
                        library_ms=row["library_ms"], factor=factor,
                        met=row["ms"] <= factor * row["library_ms"]))
    return out


def _tap_tables_cases(scales, randn) -> list:
    """stencil_tap_tables_sum at corr1's correlation adjoint: z (H1, 65 x
    64) gathered through uniq_inv (65, H2)."""
    import torch
    from hplflownet_tpu_torch.kernels.tap_tables import (
        stencil_tap_tables_sum, stencil_tap_tables_sum_plain)
    nb = scales[2].pc2_corr_uniq_inv.contiguous()
    f, h_out = nb.shape
    h, c = CAPACITIES[2], 64
    nnz = int((nb >= 0).sum())
    z32 = randn(h, f * c)
    ids = nb.t().clamp(min=0).long()                        # (H_out, F)
    mask = (nb.t() >= 0)[:, :, None]
    taps = torch.arange(f, device=nb.device)[None, :]
    rows = []
    for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        z = z32.to(dt)
        got = stencil_tap_tables_sum(z, c, nb)
        want = stencil_tap_tables_sum_plain(z, c, nb)
        sync()
        # the same float32 sums in the same tap order
        err = max_err(got, want, 1e-5, 1e-6, f"stencil_tap_tables_sum {dtn}")
        ms = cuda_ms(lambda: stencil_tap_tables_sum(z, c, nb))
        dms = device_ms(lambda: stencil_tap_tables_sum(z, c, nb))
        plain_ms = cuda_ms(lambda: stencil_tap_tables_sum_plain(z, c, nb), reps=3)
        z3 = z.view(h, f, c)

        def lib():
            return torch.where(mask, z3[ids, taps], 0).sum(1, dtype=torch.float32)
        lib_ms, lib_dms = cuda_ms(lib), device_ms(lib)
        nbytes = nnz * c * z.element_size() + nb.numel() * 4 + got.numel() * 4
        # one float32 add per element read
        bms, by = bound_ms(nbytes, float(nnz * c), "float32")
        row = dict(case="corr1 adjoint", dtype=dtn,
                   shape=f"H={h} F={f} C={c} H_out={h_out}", max_abs_err=err,
                   ms=ms, device_ms=dms, plain_ms=plain_ms, bound_ms=bms,
                   bound_by=by, library_ms=lib_ms, library_device_ms=lib_dms)
        rows.append(row)
        log(f"stencil_tap_tables_sum corr1 adjoint {dtn} [{row['shape']}]: "
            f"max_abs_err {err:.3e} (atol 1e-5 rtol 1e-6); kernel {ms:.4f} ms "
            f"per call, {dms:.4f} ms device, plain {plain_ms:.4f} ms, index + "
            f"sum {lib_ms:.4f} ms per call, {lib_dms:.4f} ms device, bound "
            f"{bms:.4f} ms ({by})")
    return rows


def _reduce_step_label(key) -> str:
    if key["R"] == 0:
        return "plain rows"
    return "splat" if key["with_weights"] else "slice adjoint"


def _step_cases() -> tuple:
    """Kernels 2 and 4 at every distinct shape one flagship train step
    (bf16) gives them, on the step's own inputs (recorded by
    ``tools.step_calls``): each against its plain version, a rerun bit for
    bit, kernel 2 against kernel 5 bit for bit (every step stream is a
    rank-mode plan's), ``device_ms``, the bound, the launches per step and
    per forward, and launches x (device_ms - bound).  -> (kernel 2's rows,
    kernel 4's rows)"""
    import torch
    from hplflownet_tpu_torch.kernels.rank_fused import blocked_rank_reduce
    from hplflownet_tpu_torch.kernels.splat import (rank_reduce, rank_reduce_plain,
                                                    rank_reduce_regime)
    from hplflownet_tpu_torch.kernels.tap_tables import (
        stencil_tap_tables_sum, stencil_tap_tables_sum_plain)
    from hplflownet_tpu_torch.tools.rank_cases import fused_args_from_runs
    from hplflownet_tpu_torch.tools.step_calls import flagship_calls
    calls = flagship_calls(DEVICE, NUM_POINTS, CAPACITIES)
    reduce_rows, tap_rows = [], []
    for grp in calls["rank_reduce"]:
        a, k = grp["args"], grp["key"]
        g, rid, start, end, c, with_w = (a["g"], a["rid"], a["start"], a["end"],
                                         a["c"], a["with_weights"])
        name = f"step {_reduce_step_label(k)}"
        shape = f"M={k['M']} C={k['C']} R={k['R']} T={k['T']}"
        what = f"rank_reduce {name} [{shape}]"

        def kern():
            return rank_reduce(g, rid, start, end, c, with_w)
        got, again = kern(), kern()
        want = rank_reduce_plain(g, rid, start, end, c, with_w)
        fused = fused_args_from_runs(rid, start, end, g.shape[0])
        if fused is None:
            raise AssertionError(f"{what}: not a rank-mode plan's runs")
        other = blocked_rank_reduce(g, *fused, c, k["R"], with_w)[:k["T"]]
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: rerun differs")
        if not torch.equal(got, other):
            raise AssertionError(f"{what}: not bit-equal to blocked_rank_reduce")
        err = max_err(got, want, 1e-4, 1e-5, what)
        dms = device_ms(kern)
        entries = int((end.clamp(max=k["M"]) - start.clamp(min=0))
                      .clamp(min=0).sum())
        nbytes = (entries * g.shape[1] * g.element_size()
                  + (entries * 4 if rid is not None else 0)
                  + 2 * k["T"] * 4 + got.numel() * 4)
        bms, by = bound_ms(nbytes, (2.0 if k["R"] else 1.0) * entries
                           * got.shape[1], "float32")
        row = dict(case=name, dtype=k["dtype"], shape=shape,
                   launches=grp["launches_step"],
                   launches_forward=grp["launches_forward"], max_abs_err=err,
                   device_ms=dms, bound_ms=bms, bound_by=by,
                   excess_ms=grp["launches_step"] * (dms - bms),
                   regime=rank_reduce_regime(g, rid, start, c, with_w))
        reduce_rows.append(row)
        log(f"{what} {k['dtype']}, {row['launches']} per step "
            f"({row['launches_forward']} per forward): max_abs_err {err:.3e} "
            f"(atol 1e-4 rtol 1e-5), rerun and blocked_rank_reduce "
            f"bit-identical; {dms:.4f} ms device, bound {bms:.4f} ms ({by}); "
            f"launches x (device - bound) {row['excess_ms']:.4f} ms; regime "
            f"{row['regime']}")
    for grp in calls["stencil_tap_tables_sum"]:
        a, k = grp["args"], grp["key"]
        z, c, nb = a["tables"], a["c"], a["neighbors"]
        shape = f"H={k['H']} F={k['F']} C={k['C']} H_out={k['H_out']}"
        what = f"stencil_tap_tables_sum step corr adjoint [{shape}]"

        def kern():
            return stencil_tap_tables_sum(z, c, nb)
        got, again = kern(), kern()
        want = stencil_tap_tables_sum_plain(z, c, nb)
        sync()
        if not torch.equal(got, again):
            raise AssertionError(f"{what}: rerun differs")
        err = max_err(got, want, 1e-5, 1e-6, what)
        dms = device_ms(kern)
        nnz = int(((nb >= 0) & (nb < k["H"])).sum())
        nbytes = nnz * c * z.element_size() + nb.numel() * 4 + got.numel() * 4
        bms, by = bound_ms(nbytes, float(nnz * c), "float32")
        row = dict(case="step corr adjoint", dtype=k["dtype"], shape=shape,
                   launches=grp["launches_step"],
                   launches_forward=grp["launches_forward"], max_abs_err=err,
                   device_ms=dms, bound_ms=bms, bound_by=by,
                   excess_ms=grp["launches_step"] * (dms - bms),
                   present=nnz / nb.numel())
        tap_rows.append(row)
        log(f"{what} {k['dtype']}, {row['launches']} per step: max_abs_err "
            f"{err:.3e} (atol 1e-5 rtol 1e-6), rerun bit-identical; {dms:.4f} "
            f"ms device, bound {bms:.4f} ms ({by}); present taps "
            f"{row['present']:.3f}")
    return reduce_rows, tap_rows


def _reduce_edge_cases(dev) -> list:
    """``rank_reduce`` (kernel 2) on the edge cases of
    ``tools.rank_cases.reduce_cases`` (long and empty runs, clamped runs,
    lanes outside [0, R), odd pitches, R 0-4) in both dtypes: a rerun bit
    for bit, the plain version within atol 1e-4 + rtol 1e-5, and kernel 5
    bit for bit where the stream is a plan's."""
    import torch
    from hplflownet_tpu_torch.kernels.rank_fused import blocked_rank_reduce
    from hplflownet_tpu_torch.kernels.splat import rank_reduce, rank_reduce_plain
    from hplflownet_tpu_torch.tools.rank_cases import reduce_cases, to_torch
    rows = []
    for case in reduce_cases():
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            a = to_torch(case, dt, dev)
            g, rid = a["g"], a.get("rid")
            what = f"rank_reduce edge {case.name} {dtn}"

            def kern():
                return rank_reduce(g, rid, a["start"], a["end"], case.c,
                                   case.with_weights)
            got, again = kern(), kern()
            want = rank_reduce_plain(g, rid, a["start"], a["end"], case.c,
                                     case.with_weights)
            plan = case.meta is not None
            other = (blocked_rank_reduce(g, a["meta"], a["start_rows"], case.c,
                                         case.r, case.with_weights)
                     [:case.start.shape[0]] if plan else None)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: rerun differs")
            if plan and not torch.equal(got, other):
                raise AssertionError(f"{what}: not bit-equal to "
                                     f"blocked_rank_reduce")
            err = max_err(got, want, 1e-4, 1e-5, what)
            dms = device_ms(kern)
            bms, by = bound_ms(g.numel() * g.element_size() + got.numel() * 4,
                               2.0 * g.shape[0] * got.shape[1], "float32")
            row = dict(case=f"edge {case.name}", dtype=dtn,
                       shape=f"M={g.shape[0]} C={case.c} R={case.r} "
                       f"T={case.start.shape[0]}", max_abs_err=err,
                       device_ms=dms, bound_ms=bms, bound_by=by,
                       blocked_rank_reduce_equal=plan)
            rows.append(row)
            log(f"{what} [{row['shape']}]: max_abs_err {err:.3e} (atol 1e-4 "
                f"rtol 1e-5), rerun " + ("and blocked_rank_reduce " if plan
                                         else "") + f"bit-identical; "
                f"{dms:.4f} ms device")
    return rows


def _tap_edge_cases(dev) -> list:
    """``stencil_tap_tables_sum`` (kernel 4) on the edge cases of
    ``tools.tap_cases`` (vertices with no and with one present tap, ragged
    H_out, C 3, 36, 64 and 384) in both dtypes: a rerun bit for bit and the
    plain version within atol 1e-5 + rtol 1e-6 (both sum in tap order)."""
    import torch
    from hplflownet_tpu_torch.kernels.tap_tables import (
        stencil_tap_tables_sum, stencil_tap_tables_sum_plain)
    from hplflownet_tpu_torch.tools.tap_cases import tap_cases
    rows = []
    for case in tap_cases():
        nb = torch.from_numpy(case.nb).to(dev)
        for dtn, dt in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
            tables = torch.from_numpy(case.tables).to(dev, dt)
            what = f"stencil_tap_tables_sum edge {case.name} {dtn}"
            got = stencil_tap_tables_sum(tables, case.c, nb)
            again = stencil_tap_tables_sum(tables, case.c, nb)
            want = stencil_tap_tables_sum_plain(tables, case.c, nb)
            sync()
            if not torch.equal(got, again):
                raise AssertionError(f"{what}: rerun differs")
            err = max_err(got, want, 1e-5, 1e-6, what)
            f, h_out = case.nb.shape
            row = dict(case=f"edge {case.name}", dtype=dtn,
                       shape=f"H={case.tables.shape[0]} F={f} C={case.c} "
                       f"H_out={h_out}", max_abs_err=err)
            rows.append(row)
            log(f"{what} [{row['shape']}]: max_abs_err {err:.3e} (atol 1e-5 "
                f"rtol 1e-6), rerun bit-identical")
    return rows


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

    from hplflownet_tpu_torch.train.step import loss_and_grad
    tref = np.load(TRAIN_REF_NPZ)
    params_from_jax(seeded_jax_params(model, int(tref["seed"])), model)
    n = tref["pc1"].shape[1]
    batch = dict(pc1=tref["pc1"], pc2=tref["pc2"], sf=tref["sf"],
                 valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool))
    loss, _, grads = loss_and_grad(
        model, make_lattice_spec(SFM7, [int(c) for c in tref["capacities"]]),
        dict(model.named_parameters()), batch)
    rows = check_train_reference(tref, float(loss), grads)
    log(f"n=64 float32 train step through the kernels vs frozen JAX: loss "
        f"{float(loss):.8f} (JAX {float(tref['loss']):.8f}); per leaf worst "
        + "; ".join(f"vs {r['against']}: norm {r['worst_norm']:.2e}, dot/norm "
                    f"{r['worst_dot']:.2e}" for r in rows)
        + f" (limits {TRAIN_TOL})")


# a bf16 flow against another order of its sums (the plain versions, a
# sharded forward): a one-ulp rounding flip (2^-8) in one layer spreads
# through the next ones, so the two differ by ~1e-2
FLOW_REL_TOL = 5e-2


def _flow_rel(got, want) -> tuple:
    """(max abs, max abs / max |want|) of two flows."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    err = float((got - want).abs().max())
    return err, err / float(want.abs().max())


def phase_main_path(results):
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.kernels.stencil_plan import make_stencil_plan
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    from hplflownet_tpu_torch.tools.step_calls import check_calls, recorded_calls

    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    pc1, pc2 = pc1[0], pc2[0]
    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)

    wrappers = {k: w for k, w in _kernel_wrappers().items()
                if k in FORWARD_KERNELS}
    make_stencil_plan.builds = 0
    flow, launches = _counted(wrappers, lambda: flow_forward(
        model, spec, pc1, pc2, adjoint_plans=False))
    builds = make_stencil_plan.builds
    log(f"main path launches: {launches}; stencil plans built: {builds}")
    _require_launches("the main path", launches)
    if DEVICE == "cuda" and launches["dense_gemm"] != FLAGSHIP_DENSE:
        raise AssertionError(f"the main path: {launches['dense_gemm']} "
                             f"dense_gemm launches, not one per dense product "
                             f"({FLAGSHIP_DENSE})")
    if DEVICE == "cuda" and launches["slice_points"] != FLAGSHIP_SLICES:
        raise AssertionError(f"the main path: {launches['slice_points']} "
                             f"slice_points launches, not one per slice "
                             f"({FLAGSHIP_SLICES})")
    results["forward_launches"] = launches
    with recorded_calls() as calls:
        flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    results["main_calls"] = check_calls(calls, CALL_TOL)
    del calls
    log("main path, every kernel call vs its plain version: "
        + "; ".join(f"{k} {v['calls']} calls at {v['shapes']} shapes, worst "
                    f"{v['worst']:.3e}" for k, v in results["main_calls"].items()))

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
    results.setdefault("plans", {})["builds_forward"] = builds

    before = {k: w.launches for k, w in wrappers.items()}
    with plain_kernels():
        flow_plain = flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    sync()
    if any(w.launches != before[k] for k, w in wrappers.items()):
        raise AssertionError("a kernel launched inside plain_kernels()")
    err, rel = _flow_rel(flow, flow_plain)
    if rel > FLOW_REL_TOL:
        raise AssertionError(f"bf16 flow, kernels vs plain: max abs {err:.3e}, "
                             f"max rel {rel:.3e} > {FLOW_REL_TOL}")
    log(f"bf16 flow, kernels vs plain versions on the card: max abs "
        f"{err:.3e}, max rel {rel:.3e} (limit {FLOW_REL_TOL})")

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


def phase_train(results):
    """The flagship train step on the card: launches, plain compare,
    determinism, ms/step."""
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.kernels.stencil_plan import make_stencil_plan
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import make_lattice_spec
    from hplflownet_tpu_torch.tools.step_calls import check_calls, recorded_calls
    from hplflownet_tpu_torch.train.step import loss_and_grad, make_train_step

    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in dict(
        pc1=pc1, pc2=pc2, sf=pc2 - pc1, valid1=np.ones((1, NUM_POINTS), bool),
        valid2=np.ones((1, NUM_POINTS), bool)).items()}
    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)
    init, step = make_train_step(model, spec, learning_rate=1e-4,
                                 on_overflow="skip", device=DEVICE)
    state = init()

    wrappers = _kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    make_stencil_plan.builds = 0
    new_state, loss, overflow = step.with_overflow(state, batch)
    sync()
    launches = {k: w.launches for k, w in wrappers.items()}
    results.setdefault("plans", {})["builds_step"] = make_stencil_plan.builds
    log(f"train step launches: {launches}; stencil plans built: "
        f"{make_stencil_plan.builds}")
    for k, n in launches.items():
        if n <= 0 and DEVICE == "cuda":      # a CPU rehearsal launches nothing
            raise AssertionError(f"{k} was not launched in the train step")
    results["launches"] = launches
    if int(overflow) != 0 or int(new_state.step) != 1:
        raise AssertionError(f"train step: overflow {int(overflow)}, step "
                             f"{int(new_state.step)}")

    # every kernel call of one step's gradients on its own inputs
    with recorded_calls() as calls:
        loss_and_grad(model, spec, state.params, batch)
    results["train_calls"] = check_calls(calls, CALL_TOL)
    del calls
    log("train step, every kernel call vs its plain version: "
        + "; ".join(f"{k} {v['calls']} calls at {v['shapes']} shapes, worst "
                    f"{v['worst']:.3e}" for k, v in results["train_calls"].items()))

    # two gradient evaluations on the same state: bit for bit
    loss1, _, g1 = loss_and_grad(model, spec, state.params, batch)
    loss2, _, g2 = loss_and_grad(model, spec, state.params, batch)
    sync()
    differ = [k for k in g1 if not torch.equal(g1[k], g2[k])]
    if differ or not torch.equal(loss1, loss2):
        raise AssertionError(f"gradients differ between two evaluations: {differ[:5]}")
    # the same gradients with the plain versions forced, in bf16 and, on a
    # float32 copy of the model, in float32
    model32 = HPLFlowNet(SFM7, compute_dtype="float32", device=DEVICE)
    params_from_jax(seeded_jax_params(model32, 0), model32)
    p32 = dict(model32.named_parameters())
    _, _, g32 = loss_and_grad(model32, spec, p32, batch)
    before = {k: w.launches for k, w in wrappers.items()}
    with plain_kernels():
        loss_p, _, gp = loss_and_grad(model, spec, state.params, batch)
        _, _, gp32 = loss_and_grad(model32, spec, p32, batch)
    sync()
    if any(w.launches != before[k] for k, w in wrappers.items()):
        raise AssertionError("a kernel launched inside plain_kernels()")

    def summary(rel):
        worst = max(rel, key=rel.get)
        return worst, rel[worst], float(np.median(list(rel.values())))

    # float32: the kernels sum in another order than the plain versions
    w32, r32, m32 = summary(leaf_rel(g32, gp32))
    if r32 > 1e-3:
        raise AssertionError(f"float32 gradients, kernels vs plain: {w32} max "
                             f"rel {r32:.3e} > 1e-3")
    # bf16: activations and cotangents round to bf16 at every layer, so a
    # one-ulp flip anywhere moves the later ones; the plain bf16 step itself
    # lies up to ~8e-2 (median ~2e-2) of a leaf's max from the float32
    # gradient, and the kernels' bf16 step must stay as close to it
    wb, rb, mb = summary(leaf_rel(g1, gp))
    _, noise, noise_med = summary(leaf_rel(gp, gp32))
    _, to32, to32_med = summary(leaf_rel(g1, gp32))
    if rb > 1e-1 or mb > 2e-2 or to32 > max(1e-1, 1.5 * noise):
        raise AssertionError(
            f"bf16 gradients, kernels vs plain: {wb} max rel {rb:.3e} (limit "
            f"1e-1), median {mb:.3e} (limit 2e-2); kernels vs float32 {to32:.3e}, "
            f"plain bf16 vs float32 {noise:.3e}")
    results["train_grad_rel"] = dict(f32=r32, bf16=rb, bf16_median=mb,
                                     bf16_to_f32=to32, plain_bf16_to_f32=noise)
    log(f"train step gradients per leaf, max|d|/max|g|: float32 kernels vs plain "
        f"worst {r32:.3e} ({w32}), median {m32:.3e} (limit 1e-3); bf16 kernels "
        f"vs plain worst {rb:.3e} ({wb}), median {mb:.3e} (limits 1e-1, 2e-2); "
        f"bf16 vs the float32 gradient: kernels {to32:.3e} (median "
        f"{to32_med:.3e}), plain {noise:.3e} (median {noise_med:.3e}); bf16 loss "
        f"{float(loss1):.6f} vs plain {float(loss_p):.6f}; two evaluations "
        f"bit-identical")
    del model32, p32, g32, gp32, g1, g2, gp

    losses = []
    for _ in range(TRAIN_WARMUP):
        state, loss = step(state, batch)
        losses.append(loss)
    sync()
    t0 = time.perf_counter()
    if DEVICE == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
    for _ in range(TRAIN_REPS):
        state, loss = step(state, batch)
        losses.append(loss)
    if DEVICE == "cuda":
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / TRAIN_REPS
    else:                                       # CPU rehearsal only
        ms = (time.perf_counter() - t0) * 1e3 / TRAIN_REPS
    losses = torch.stack(losses).float().cpu().numpy()
    if not np.isfinite(losses).all() or int(state.step) != len(losses):
        raise AssertionError(f"train losses {losses}, step {int(state.step)}")
    results["train_ms"] = ms
    log(f"flagship train step (8192-point pair, batch 1, bf16, Adam, overflow "
        f"skip) on {results.get('card', DEVICE)}: {ms:.2f} ms/step = "
        f"{1e3 / ms:.2f} train pairs/s over {TRAIN_REPS} steps after "
        f"{TRAIN_WARMUP} warm-up; losses {np.round(losses, 5).tolist()}")


def phase_fused(results):
    """The forward and one train step under HPL_RANK_FUSED=1: launches, the
    flow and gradients against the default route, ms/pair and ms/step."""
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels.rank_fused import blocked_rank_reduce
    from hplflownet_tpu_torch.kernels.splat import rank_reduce
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    from hplflownet_tpu_torch.train.step import loss_and_grad, make_train_step

    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in dict(
        pc1=pc1, pc2=pc2, sf=pc2 - pc1, valid1=np.ones((1, NUM_POINTS), bool),
        valid2=np.ones((1, NUM_POINTS), bool)).items()}
    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)
    init, step = make_train_step(model, spec, learning_rate=1e-4,
                                 on_overflow="skip", device=DEVICE)
    state = init()
    wrappers = {"blocked_rank_reduce": blocked_rank_reduce,
                "rank_reduce": rank_reduce}

    def fwd():
        return flow_forward(model, spec, pc1[0], pc2[0], adjoint_plans=False)

    def counted(fn):
        for w in wrappers.values():
            w.launches = 0
        out = fn()
        sync()
        return out, {k: w.launches for k, w in wrappers.items()}

    def fused(on: bool):
        if on:
            os.environ["HPL_RANK_FUSED"] = "1"
        else:
            os.environ.pop("HPL_RANK_FUSED", None)

    saved = os.environ.get("HPL_RANK_FUSED")
    ms = {"pair": {False: [], True: []}, "step": {False: [], True: []}}
    try:
        fused(False)
        flow0, default_fwd = counted(fwd)
        _, _, g0 = loss_and_grad(model, spec, state.params, batch)
        fused(True)
        flow1, fused_fwd = counted(fwd)
        (new_state, loss, overflow), fused_step = counted(
            lambda: step.with_overflow(state, batch))
        _, _, g1 = loss_and_grad(model, spec, state.params, batch)
        sync()
        st = [new_state]

        def one():
            st[0], _ = step(st[0], batch)
        # the two routes in turns (default, fused, fused, default): host
        # times spread between calls and over a call
        for on in (False, True, True, False):
            fused(on)
            ms["pair"][on].append(cuda_ms(fwd, reps=5, warmup=1))
            ms["step"][on].append(cuda_ms(one, reps=TRAIN_REPS, warmup=1))
    finally:
        if saved is None:
            os.environ.pop("HPL_RANK_FUSED", None)
        else:
            os.environ["HPL_RANK_FUSED"] = saved
    log(f"launches: default forward {default_fwd}; fused forward {fused_fwd}; "
        f"fused train step {fused_step}")
    if DEVICE == "cuda":                        # a CPU rehearsal launches nothing
        if default_fwd["blocked_rank_reduce"] or not default_fwd["rank_reduce"]:
            raise AssertionError(f"default route launches {default_fwd}")
        for what, n in (("forward", fused_fwd), ("train step", fused_step)):
            if n["rank_reduce"] or n["blocked_rank_reduce"] <= 0:
                raise AssertionError(f"fused {what} launches {n}")
    if int(overflow) != 0 or not torch.isfinite(loss):
        raise AssertionError(f"fused train step: overflow {int(overflow)}, "
                             f"loss {float(loss)}")
    # both routes sum every run in stream order: the same bits
    if not torch.equal(flow0, flow1):
        err = float((flow0.float() - flow1.float()).abs().max())
        raise AssertionError(f"fused flow differs from the default: {err:.3e}")
    differ = [k for k in g0 if not torch.equal(g0[k], g1[k])]
    if differ:
        raise AssertionError(f"fused gradients differ from the default: {differ[:5]}")
    results["fused_launches"] = fused_step
    results["fused_forward_launches"] = fused_fwd
    results["fused_ms"] = {k: {"fused" if on else "default": v[on]
                               for on in (False, True)} for k, v in ms.items()}
    log(f"fused route: flow and all {len(g0)} gradient leaves bit-identical "
        f"to the default route; in turns default/fused/fused/default: "
        + "; ".join(f"ms/{k} default {np.round(v[False], 2).tolist()}, fused "
                    f"{np.round(v[True], 2).tolist()}" for k, v in ms.items())
        + f"; HPL_RANK_FUSED restored to {os.environ.get('HPL_RANK_FUSED')!r}")


def _kernel_wrappers() -> dict:
    """The wrappers of kernels 1-4, the main path's, by name."""
    from hplflownet_tpu_torch.kernels import main_path_wrappers
    return main_path_wrappers()


def _counted(wrappers: dict, fn):
    """``fn()`` with the wrappers' launch counts set to 0 just before and
    read just after (the device synchronised) -> (result, counts)."""
    from hplflownet_tpu_torch.kernels import count_launches

    def run():
        out = fn()
        sync()
        return out
    return count_launches(run, wrappers)


def _require_launches(what: str, launches: dict) -> None:
    if DEVICE == "cuda":                        # a CPU rehearsal launches nothing
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise AssertionError(f"{what}: {missing} not launched ({launches})")


# a kernel call vs its plain version on the same inputs, max|d| / max|plain|:
# a bf16 output differs by at most an ulp or two (2^-8 of the value), a
# float32 one by the order of its float32 sums
CALL_TOL = {"bf16": 1.6e-2, "f32": 1e-4}


def leaf_rel(a: dict, b: dict) -> dict:
    """Per gradient leaf: max|a - b| / max|b|."""
    return {k: float((a[k].float() - b[k].float()).abs().max()
                     / b[k].float().abs().max().clamp_min(1e-30)) for k in b}


def phase_shallow(results):
    """HPLFlowNetShallow at full width on the card: a forward and a train
    step (launches of kernels 1-4, zero overflow), the same with the plain
    versions forced, pairs/s and ms/step, and the float32 64-point pair
    against the frozen JAX reference."""
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNetShallow
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import flow_forward, make_lattice_spec
    from hplflownet_tpu_torch.tools.step_calls import check_calls, recorded_calls
    from hplflownet_tpu_torch.train.step import loss_and_grad, make_train_step

    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in dict(
        pc1=pc1, pc2=pc2, sf=pc2 - pc1, valid1=np.ones((1, NUM_POINTS), bool),
        valid2=np.ones((1, NUM_POINTS), bool)).items()}
    spec = make_lattice_spec(SFM5, SHALLOW_CAPACITIES)
    model = HPLFlowNetShallow(SFM5, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)
    init, step = make_train_step(model, spec, learning_rate=1e-4,
                                 on_overflow="skip", device=DEVICE)
    state = init()
    wrappers = _kernel_wrappers()

    def fwd():
        return flow_forward(model, spec, pc1[0], pc2[0], adjoint_plans=False)

    flow, fwd_launches = _counted(wrappers, fwd)
    (new_state, loss, overflow), step_launches = _counted(
        wrappers, lambda: step.with_overflow(state, batch))
    log(f"shallow launches: forward {fwd_launches}; train step {step_launches}")
    _require_launches("shallow forward", {k: fwd_launches[k] for k in
                                          FORWARD_KERNELS})
    _require_launches("shallow train step", step_launches)
    with torch.inference_mode():
        scales = build_pyramid(spec, batch["pc1"][0], batch["pc2"][0])
    oflow = [[int(s.pc1_overflow), int(s.pc2_overflow), int(s.probe_overflow),
              int(s.stencil_overflow)] for s in scales]
    counts = [[int(s.pc1_num_valid), int(s.pc2_num_valid)] for s in scales]
    if int(overflow) != 0 or any(any(o) for o in oflow) \
            or int(new_state.step) != 1 or not torch.isfinite(loss):
        raise AssertionError(f"shallow train step: overflow {int(overflow)} "
                             f"({oflow}), step {int(new_state.step)}, loss "
                             f"{float(loss)}")
    out = flow.float().cpu().numpy()
    if out.shape != (NUM_POINTS, 3) or not np.isfinite(out).all():
        raise AssertionError(f"shallow flow shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    log(f"shallow flow {out.shape} finite; overflow 0; vertices per scale "
        f"{counts} of capacities {SHALLOW_CAPACITIES}")

    # every kernel call of one step on its own inputs, kernel vs plain
    with recorded_calls() as calls:
        _, _, g1 = loss_and_grad(model, spec, state.params, batch)
    per_call = check_calls(calls, CALL_TOL)
    del calls
    log("shallow train step, each kernel call against its plain version on "
        "the same inputs, max|d| / max|plain| (limits: bf16 out "
        f"{CALL_TOL['bf16']}, float32 out {CALL_TOL['f32']}): "
        + "; ".join(f"{k} {v['calls']} calls at {v['shapes']} shapes, worst "
                    f"{v['worst']:.2e}" for k, v in per_call.items()))
    # the same forward and gradients with the plain versions forced, and
    # the float32 gradient (plain) that bf16 rounding is measured against
    model32 = HPLFlowNetShallow(SFM5, compute_dtype="float32", device=DEVICE)
    params_from_jax(seeded_jax_params(model32, 0), model32)
    p32 = dict(model32.named_parameters())
    _, _, g32 = loss_and_grad(model32, spec, p32, batch)
    before = {k: w.launches for k, w in wrappers.items()}
    with plain_kernels():
        ref = fwd().float().cpu().numpy()
        _, _, gp = loss_and_grad(model, spec, state.params, batch)
        _, _, gp32 = loss_and_grad(model32, spec, p32, batch)
    sync()
    if any(w.launches != before[k] for k, w in wrappers.items()):
        raise AssertionError("a kernel launched inside plain_kernels()")
    rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    r32 = leaf_rel(g32, gp32)
    grel, noise, to32 = leaf_rel(g1, gp), leaf_rel(gp, gp32), leaf_rel(g1, gp32)
    worst = max(grel, key=grel.get)
    median = float(np.median(list(grel.values())))
    # bf16 rounds activations and cotangents at every layer, and a one-ulp
    # flip moves the later layers; at the coarsest scale (83 vertices) that
    # noise exceeds the train phase's 1e-1 limit on a leaf's max (the plain bf16
    # step lies up to 0.157 of it from float32 on corr3_refine).  The kernels are held to their plain
    # versions call by call above; here the bf16 step must be as close to
    # the float32 gradient as the plain bf16 step is (the train phase's rule) and
    # its median leaf within 2e-2 of the plain one.
    w32 = max(r32, key=r32.get)
    n_worst = max(noise, key=noise.get)
    t_worst = max(to32, key=to32.get)
    beyond = sorted(k for k in grel if grel[k] > 1e-1)
    log(f"shallow, kernels vs plain versions: bf16 flow max rel {rel:.3e} "
        f"(limit 5e-2); float32 gradients per leaf worst {r32[w32]:.3e} "
        f"({w32}; limit 1e-3); bf16 gradients worst {grel[worst]:.3e} "
        f"({worst}), median {median:.3e} (limit 2e-2); distance from the "
        f"float32 gradient: kernels bf16 {to32[t_worst]:.3e} ({t_worst}), "
        f"plain bf16 {noise[n_worst]:.3e} ({n_worst}) (limit max(1e-1, 1.5x "
        f"plain)); leaves past 1e-1 kernels vs plain, with kernels / plain "
        f"distance from float32: "
        + (", ".join(f"{k} {grel[k]:.3e} ({to32[k]:.3e} / {noise[k]:.3e})"
                     for k in beyond) or "none"))
    if rel > 5e-2 or r32[w32] > 1e-3 or median > 2e-2 \
            or to32[t_worst] > max(1e-1, 1.5 * noise[n_worst]):
        raise AssertionError("shallow, kernels vs plain: past a limit (above)")
    del g1, gp, g32, gp32, model32, p32

    st = [new_state]

    def one():
        st[0], _ = step(st[0], batch)
    ms_pair = cuda_ms(fwd, reps=5, warmup=1)
    ms_step = cuda_ms(one, reps=TRAIN_REPS, warmup=TRAIN_WARMUP)
    if int(st[0].step) != 1 + TRAIN_WARMUP + TRAIN_REPS:
        raise AssertionError(f"shallow steps taken: {int(st[0].step)}")
    results["shallow"] = dict(forward_launches=fwd_launches,
                              step_launches=step_launches, ms_pair=ms_pair,
                              pairs_per_s=1e3 / ms_pair, ms_step=ms_step,
                              flow_rel_plain=rel, grad_rel_plain=grel[worst],
                              grad_rel_plain_median=median,
                              grad_rel_plain_f32=r32[w32], per_call=per_call,
                              bf16_to_f32=to32[t_worst],
                              plain_bf16_to_f32=noise[n_worst],
                              leaves_past_1e1=beyond, vertices=counts)
    log(f"shallow forward ({NUM_POINTS}-point pair, bf16, lattice build included): "
        f"{ms_pair:.2f} ms/pair = {1e3 / ms_pair:.2f} pairs/s; train step "
        f"(batch 1, Adam, overflow skip): {ms_step:.2f} ms/step over "
        f"{TRAIN_REPS} steps after {TRAIN_WARMUP} warm-up")

    # float32, 64 points: the kernels against the frozen JAX reference
    ref = np.load(SHALLOW_REF_NPZ)
    model32 = HPLFlowNetShallow(SFM5, compute_dtype="float32", device=DEVICE)
    params_from_jax(seeded_jax_params(model32, int(ref["seed"])), model32)
    spec32 = make_lattice_spec(SFM5, [int(c) for c in ref["capacities"]])
    got = flow_forward(model32, spec32, ref["pc1"][0], ref["pc2"][0],
                       adjoint_plans=False).cpu().numpy()
    err = float(np.abs(got - ref["flow"]).max())
    frel = err / float(np.abs(ref["flow"]).max())
    if not (got.shape == ref["flow"].shape and err <= 1e-3 and frel <= 5e-3):
        raise AssertionError(f"shallow n=64 float32 flow vs JAX: max abs "
                             f"{err:.3e}, max rel {frel:.3e}")
    n = ref["pc1"].shape[1]
    loss32, _, g32 = loss_and_grad(
        model32, spec32, dict(model32.named_parameters()),
        dict(pc1=ref["pc1"], pc2=ref["pc2"], sf=ref["sf"],
             valid1=np.ones((1, n), bool), valid2=np.ones((1, n), bool)))
    rows = check_train_reference(ref, float(loss32), g32)
    results["shallow"]["reference"] = dict(flow_abs=err, flow_rel=frel, rows=rows)
    log(f"shallow n=64 float32 through the kernels vs frozen JAX: flow max abs "
        f"{err:.3e}, max rel {frel:.3e} (limits 1e-3 / 5e-3); train step loss "
        f"{float(loss32):.8f} (JAX {float(ref['loss']):.8f}), per leaf worst "
        + "; ".join(f"vs {r['against']}: norm {r['worst_norm']:.2e}, dot/norm "
                    f"{r['worst_dot']:.2e}" for r in rows))


# the driver phase: frames of this many points, sampled to NUM_POINTS
DRIVER_FRAME_POINTS = 10240
DRIVER_TRAIN_SEEDS, DRIVER_VAL_SEEDS = (0, 1, 2, 3), (4, 5, 6)


def write_ft3d_frames(root: str, n_points: int) -> None:
    """A FlyingThings3D-layout directory of synthetic frames
    (``synthetic_frustum_clouds``, one seed a frame), stored with x and z
    negated as the processed dataset is (the loader flips them back)."""
    import numpy as np
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    base = os.path.join(root, "FlyingThings3D_subset_processed_35m")
    for split, seeds in (("train", DRIVER_TRAIN_SEEDS), ("val", DRIVER_VAL_SEEDS)):
        for i, seed in enumerate(seeds):
            d = os.path.join(base, split, f"{i:07d}")
            os.makedirs(d)
            pcs = synthetic_frustum_clouds(1, n_points, seed=seed)
            for name, pc in zip(("pc1", "pc2"), pcs):
                np.save(os.path.join(d, f"{name}.npy"),
                        pc[0] * np.array([-1, 1, -1], np.float32))


def driver_config(root: str) -> dict:
    """The flagship trained one epoch by ``train.driver.run``:
    configs/train_ours.yaml's model, data processing and augmentation at
    batch 2 and bf16, capacities measured on the val set."""
    cfg = {
        "ckpt_dir": os.path.join(root, "ckpt"), "data_root": os.path.join(root, "data"),
        "resume": False, "arch": "HPLFlowNet", "last_relu": False,
        "allow_less_points": True, "use_leaky": True, "bcn_use_bias": True,
        "bcn_use_norm": True, "custom_lr": True, "lr_switch_epochs": "0",
        "lrs": "0.0001", "batch_size": 2, "epochs": 1,
        "scales_filter_map": SFM7, "dim": 3, "num_points": NUM_POINTS,
        "compute_dtype": "bfloat16", "evaluate": False,
        "dataset": "FlyingThings3DSubset", "full": True, "strict": False,
        "data_process": {"DEPTH_THRESHOLD": 35.0, "NO_CORR": True},
        "aug_together": {"degree_range": 0.1745329252, "shift_range": 1.0,
                         "scale_low": 0.95, "scale_high": 1.05,
                         "jitter_sigma": 0.01, "jitter_clip": 0.0},
        "aug_pc2": {"degree_range": 0.0, "shift_range": 0.3,
                    "jitter_sigma": 0.01, "jitter_clip": 0.0},
        "print_freq": 1, "workers": 2}
    if DEVICE == "cpu":
        cfg["platform"] = "cpu"
    return cfg


def phase_driver(results):
    """``train.driver.run`` end to end: the flagship trained one epoch on a
    synthetic FT3D-layout directory, then evaluated twice from the
    checkpoint."""
    import tempfile
    import numpy as np
    import torch
    from hplflownet_tpu_torch.train.checkpoint import CheckpointIO
    from hplflownet_tpu_torch.train.driver import run
    from hplflownet_tpu_torch.utils.config import Config, postprocess
    metrics = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")
    wrappers = _kernel_wrappers()
    with tempfile.TemporaryDirectory() as tmp:
        write_ft3d_frames(os.path.join(tmp, "data"), DRIVER_FRAME_POINTS)
        cfg = driver_config(tmp)
        trained, train_launches = _counted(
            wrappers, lambda: run(postprocess(Config(cfg))))
        _require_launches("driver training", train_launches)
        if trained["overflowed_steps"] or not np.isfinite(trained["train_epe3d"]) \
                or not np.isfinite(trained["min_val_epe3d"]):
            raise AssertionError(f"driver training: {trained['overflowed_steps']} "
                                 f"steps overflowed, train EPE3D "
                                 f"{trained['train_epe3d']}, val "
                                 f"{trained['min_val_epe3d']}")
        io = CheckpointIO(cfg["ckpt_dir"])
        if not io.exists("model_best"):
            raise AssertionError("driver training wrote no model_best")
        state = trained["state"]
        restored, epoch, _ = io.restore(state)
        differ = [k for k in state.params
                  if not torch.equal(restored.params[k], state.params[k])]
        if differ or epoch != 1:
            raise AssertionError(f"restored checkpoint (epoch {epoch}) differs "
                                 f"from the trained state: {differ[:5]}")
        ev = dict(cfg, evaluate=True, resume=cfg["ckpt_dir"])
        (first, second), eval_launches = _counted(
            wrappers, lambda: (run(postprocess(Config(ev))),
                               run(postprocess(Config(ev)))))
        _require_launches("driver evaluation", {k: eval_launches[k] for k in
                                                FORWARD_KERNELS})
        bad = [k for k in metrics if not np.isfinite(first[k])]
        differ = [k for k in metrics if first[k] != second[k]]
        if bad or differ or first["overflowed_batches"]:
            raise AssertionError(f"driver evaluation: non-finite {bad}, differ "
                                 f"between two runs {differ}, overflowed "
                                 f"batches {first['overflowed_batches']}")
    results["driver"] = dict(
        train_launches=train_launches, eval_launches=eval_launches,
        train_pairs_per_s=trained["train_pairs_per_s"],
        train_first_step_s=trained["seconds_to_first_step"],
        eval_pairs_per_s=[first["pairs_per_s"], second["pairs_per_s"]],
        eval_first_step_s=[first["seconds_to_first_step"],
                           second["seconds_to_first_step"]],
        metrics={k: first[k] for k in metrics},
        train_epe3d=trained["train_epe3d"], val_epe3d=trained["min_val_epe3d"])
    log(f"driver launches: training {train_launches}; two evaluations "
        f"{eval_launches}")
    log(f"driver (flagship, bf16, batch 2, {len(DRIVER_TRAIN_SEEDS)} train / "
        f"{len(DRIVER_VAL_SEEDS)} val frames of {DRIVER_FRAME_POINTS} points "
        f"sampled to {NUM_POINTS}): train {trained['train_pairs_per_s']:.2f} "
        f"pairs/s (StepTimer), {trained['seconds_to_first_step']:.2f} s from "
        f"run() to the end of the first step, 0 overflowed steps, train EPE3D "
        f"{trained['train_epe3d']:.4f}, val {trained['min_val_epe3d']:.4f}; "
        f"checkpoint restored bit for bit; evaluation "
        f"{first['pairs_per_s']:.2f} / {second['pairs_per_s']:.2f} pairs/s, "
        f"{first['seconds_to_first_step']:.2f} / "
        f"{second['seconds_to_first_step']:.2f} s to the first batch's end; "
        f"six metrics bit-identical twice: "
        + ", ".join(f"{k} {first[k]:.4f}" for k in metrics))


def phase_tools(results):
    """The op microbench and both labs at few reps (row_take and
    rank_partial must launch there), and the build's stages
    (``tools.pyramid_bench``)."""
    from hplflownet_tpu_torch.kernels.rank_partial import rank_partial
    from hplflownet_tpu_torch.kernels.take import row_take
    from hplflownet_tpu_torch.tools import (gather_lab, microbench, pyramid_bench,
                                            rank_partial_lab)
    for w in (row_take, rank_partial):
        w.launches = 0
    mb = microbench.run(DEVICE, NUM_POINTS, CAPACITIES, reps=TOOLS_REPS,
                        warmup=1, width_div=TOOLS_WIDTH_DIV,
                        sort_sizes=TOOLS_SORT_SIZES)
    gl = gather_lab.run(DEVICE, NUM_POINTS, CAPACITIES, reps=TOOLS_REPS, warmup=1)
    rp = rank_partial_lab.run(DEVICE, LAB_SIZES, reps=TOOLS_REPS, warmup=1)
    sync()
    launches = {"row_take": row_take.launches,
                "rank_partial": rank_partial.launches}
    log(f"tools launches: {launches}")
    if DEVICE == "cuda" and min(launches.values()) <= 0:
        raise AssertionError(f"a tools kernel was not launched: {launches}")
    for tool in (mb, gl, rp):
        bad = [k for k, v in tool["ms"].items() if not v > 0]
        if bad:
            raise AssertionError(f"{tool['tool']}: no time for {bad}")
    results["tools_launches"] = launches
    results["tools"] = dict(microbench=mb, gather_lab=gl, rank_partial_lab=rp)
    for tool in (mb, gl, rp):
        log(f"{tool['tool']} ({tool['clock']}): " + "; ".join(
            f"{k} {v:.4f} ms" for k, v in tool["ms"].items()))
    pb = pyramid_bench.run(DEVICE, NUM_POINTS, reps=TOOLS_REPS,
                           capacities=CAPACITIES)
    if not all(v > 0 for v in pb["ms"].values()):
        raise AssertionError(f"pyramid_bench: no time for some stage: {pb['ms']}")
    results["pyramid_bench"] = pb
    log(f"pyramid_bench ({pb['clock']}, one cloud's build and blur probes, the "
        f"pair's correlation probes, summed over scales): " + "; ".join(
            f"{k} {v:.3f} ms" for k, v in pb["stage_ms"].items())
        + f"; build_pyramid of the pair {pb['ms']['build_pyramid']:.3f} ms")


# the dp phase: the flagship at full width in float32, global batch 2, the
# second sample's valid1 cut to half; Adam at lr 1e-3 (the bounds below)
DP_CASE = dict(arch="HPLFlowNet", sfm=SFM7, capacities=CAPACITIES,
               global_batch=2, data="frustum", seed=0, lr=1e-3,
               compute_dtype="float32", valid1=[1.0, 0.5], steps=3)
DP_LOSS_RTOL, DP_GRAD_TOL = 1e-6, 1e-5        # loss; per leaf, of its max
DP_PARAM_MAX, DP_PARAM_FRAC = 2.5e-3, 1e-3    # tests/test_sharding.py:55-64


def _dp_check(what, loss, grads, params, ref_loss, ref_grads, ref_params) -> dict:
    """Hold a data-parallel step to the single-process one (tensors)."""
    rel = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    grad = leaf_rel(grads, ref_grads)
    diffs = {k: (params[k].float() - ref_params[k].float()).abs() for k in ref_params}
    pmax = max(float(d.max()) for d in diffs.values())
    pfrac = max(float((d > 1e-4).float().mean()) for d in diffs.values())
    if rel > DP_LOSS_RTOL or max(grad.values()) > DP_GRAD_TOL \
            or pmax > DP_PARAM_MAX or pfrac >= DP_PARAM_FRAC:
        raise AssertionError(
            f"{what} vs the single-process step: loss {rel:.3e} (<= {DP_LOSS_RTOL}), "
            f"worst gradient leaf {max(grad.values()):.3e} (<= {DP_GRAD_TOL}), "
            f"params max {pmax:.3e} (<= {DP_PARAM_MAX}), share above 1e-4 "
            f"{pfrac:.3e} (< {DP_PARAM_FRAC})")
    return {"loss_rel": rel, "grad_worst": max(grad.values()),
            "param_max": pmax, "param_share_above_1e-4": pfrac}


def phase_dp(results):
    """Data parallel: two gloo ranks on the one card (fresh interpreters,
    ``tools.dryrun_multiprocess``) take one ``make_dp_train_step`` step on
    the flagship, held to the single-process step on the whole batch; then
    one NCCL rank at world size 1, bit for bit against the single-process
    step on one sample."""
    import tempfile
    import torch
    import torch.distributed as dist
    from hplflownet_tpu_torch.kernels import count_launches
    from hplflownet_tpu_torch.parallel import (global_mesh, initialize,
                                               make_dp_train_step)
    from hplflownet_tpu_torch.tools import dryrun_multiprocess as dryrun
    from hplflownet_tpu_torch.train.step import loss_and_grad, make_train_step
    case = dict(DP_CASE, num_points=NUM_POINTS, capacities=CAPACITIES)
    with tempfile.TemporaryDirectory() as tmp:
        res = dryrun.run(case, procs=2, device=DEVICE, backend="gloo",
                         save_dir=tmp, timeout=600)
        ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt"), map_location=DEVICE)
                 for i in range(2)]
    for i, launches in enumerate(res["launches"]):
        _require_launches(f"dp rank {i}", launches)
    differ = [k for k in ranks[0]["grads"]
              if not torch.equal(ranks[0]["grads"][k], ranks[1]["grads"][k])]
    if differ:
        raise AssertionError(f"the two ranks' summed gradients differ: {differ[:5]}")

    model, spec, batch = dryrun.make_case(case, DEVICE)
    init_state, step = make_train_step(model, spec, case["lr"], device=DEVICE)
    state = init_state()
    _, overflow, grads = loss_and_grad(model, spec, state.params, batch)
    new, loss, _ = step.with_overflow(state, batch)
    if int(overflow) or res["overflow"]:
        raise AssertionError(f"dp: overflow {int(overflow)} / {res['overflow']}")
    gloo = _dp_check("two gloo ranks", ranks[0]["loss"], ranks[0]["grads"],
                     ranks[0]["params"], loss, grads, new.params)

    # one rank through NCCL (two ranks on one card are refused by NCCL)
    one = {k: v[:1] for k, v in batch.items()}
    dev = initialize(coordinator_address=f"127.0.0.1:{dryrun.free_port()}",
                     num_processes=1, process_id=0,
                     device="cpu" if DEVICE == "cpu" else None, timeout=300)
    try:
        backend = dist.get_backend()
        init_dp, dp_step = make_dp_train_step(model, spec, global_mesh(),
                                              case["lr"], device=dev)
        dp_state = init_dp()
        (dp_new, dp_loss, _, dp_grads), nccl_launches = count_launches(
            lambda: dp_step.with_grads(dp_state, one))
        sync()
        t = time.perf_counter()
        dp_step(dp_state, one)
        sync()
        nccl_ms = (time.perf_counter() - t) * 1e3
    finally:
        dist.destroy_process_group()
    _require_launches("dp world size 1", nccl_launches)
    one_new, one_loss, _ = step.with_overflow(state, one)
    _, _, one_grads = loss_and_grad(model, spec, state.params, one)
    differ = [k for k in one_grads if not torch.equal(dp_grads[k], one_grads[k])]
    differ += [k for k in one_new.params
               if not torch.equal(dp_new.params[k], one_new.params[k])]
    if differ or not torch.equal(dp_loss, one_loss):
        raise AssertionError(f"{backend} at world size 1 is not the single-process "
                             f"step bit for bit: loss {float(dp_loss)!r} vs "
                             f"{float(one_loss)!r}, leaves {differ[:5]}")
    results["dp"] = dict(gloo=gloo, launches=res["launches"],
                         nccl_launches=nccl_launches, backend_one=backend,
                         first_step_ms=res["first_step_ms"], step_ms=res["step_ms"],
                         one_rank_step_ms=nccl_ms, loss=res["loss"],
                         elapsed_s=res["elapsed_s"])
    log(f"dp: two gloo ranks on {res['device']} (flagship float32, global batch 2, "
        f"valid1 {case['valid1']}): loss {res['loss']:.7f}, vs one process "
        f"loss {gloo['loss_rel']:.2e}, worst gradient leaf {gloo['grad_worst']:.2e}, "
        f"params after Adam max {gloo['param_max']:.2e}; ranks bit-identical; "
        f"step ms per rank {res['step_ms']} (first {res['first_step_ms']}), "
        f"launches {res['launches']}; {res['elapsed_s']:.1f} s with the "
        f"interpreters' start")
    log(f"dp: {backend} at world size 1 equals the single-process step bit for "
        f"bit; {nccl_ms:.2f} ms/step, launches {nccl_launches}")


BENCH_REPS = 5


def phase_bench(results):
    """``hplflownet_tpu_torch.bench`` at a few reps: its JSON line (never
    the last), with every kernel 1-4 launched in its step."""
    from hplflownet_tpu_torch import bench
    res = bench.run(DEVICE, reps=BENCH_REPS, warmup=2, num_points=NUM_POINTS,
                    capacities=CAPACITIES)
    print(json.dumps(res), flush=True)
    _require_launches("bench step", res["launches"]["step"])
    _require_launches("bench forward", {k: res["launches"]["forward"][k] for k in
                                        FORWARD_KERNELS})
    results["bench"] = res
    log(f"bench: {res['value']:.2f} pairs/s ({res['forward_ms']:.2f} ms/pair), "
        f"train {res['train_step_ms']:.2f} ms/step, median of {res['reps']}; "
        f"{res['device']}, {res['power_limit_w']} W")


SYNTH_POINTS = 1024


def phase_synthetic(results):
    """The synthetic tools end to end: ``tools.train_synthetic`` (the
    shallow model, a few steps, ``--save-params``), ``tools.eval_synthetic``
    on that pickle through the driver with the scene dumps, and
    ``data.visualization``'s CLI on the dumps."""
    import tempfile
    import numpy as np
    from hplflownet_tpu_torch.data import visualization
    from hplflownet_tpu_torch.tools import eval_synthetic, train_synthetic
    metrics = ("epe3d", "acc3ds", "acc3dr", "outliers", "epe2d", "acc2d")
    dev = ["--device", "cpu"] if DEVICE == "cpu" else []
    wrappers = _kernel_wrappers()
    pairs = 4
    with tempfile.TemporaryDirectory() as tmp:
        pkl = os.path.join(tmp, "params.pkl")
        trained, train_launches = _counted(wrappers, lambda: train_synthetic.main(
            ["--num-points", str(SYNTH_POINTS), "--train-pairs", "4",
             "--val-pairs", "2", "--steps", "8", "--eval-every", "8",
             "--patches", "12", "--save-params", pkl] + dev))
        ev, eval_launches = _counted(wrappers, lambda: eval_synthetic.main(
            ["--params", pkl, "--arch", "HPLFlowNetShallow", "--num-points",
             str(SYNTH_POINTS), "--pairs", str(pairs), "--patches", "12",
             "--workdir", os.path.join(tmp, "eval")] + dev))
        ply = os.path.join(tmp, "ply")
        scenes = visualization.main([ev["visu_dir"], "--out-dir", ply])
        missing = [f"{i:04d}_{t}" for i in range(pairs)
                   for t in ("pc1.ply", "gt.ply", "pred.ply", "error.ply", "scene.html")
                   if not os.path.isfile(os.path.join(ply, f"{i:04d}_{t}"))]
    _require_launches("train_synthetic", train_launches)
    _require_launches("eval_synthetic", {k: eval_launches[k] for k in
                                         FORWARD_KERNELS})
    bad = [k for k in metrics if not np.isfinite(ev[k])]
    if bad or missing or scenes != pairs or trained["overflow_total"] \
            or ev["overflowed_batches"] or not np.isfinite(trained["final_val_epe3d"]):
        raise AssertionError(f"synthetic: non-finite {bad}, missing scene files "
                             f"{missing[:5]}, {scenes} scenes, overflow "
                             f"{trained['overflow_total']} / {ev['overflowed_batches']}")
    results["synthetic"] = dict(
        train_launches=train_launches, eval_launches=eval_launches,
        train_steps_per_sec=trained["train_steps_per_sec"],
        eval_pairs_per_s=ev["pairs_per_s"], metrics={k: ev[k] for k in metrics},
        val_epe3d=[trained["initial_val_epe3d"], trained["final_val_epe3d"]])
    log(f"synthetic (shallow, {SYNTH_POINTS} points): train_synthetic 8 steps at "
        f"{trained['train_steps_per_sec']:.2f} steps/s, val EPE3D "
        f"{trained['initial_val_epe3d']:.4f} -> {trained['final_val_epe3d']:.4f}, "
        f"launches {train_launches}; eval_synthetic {ev['pairs_per_s']:.2f} "
        f"pairs/s, launches {eval_launches}, "
        + ", ".join(f"{k} {ev[k]:.4f}" for k in metrics)
        + f"; {scenes} scenes exported (.ply and .html)")


# the large phase: large_cloud_bench's sizes on the flagship; the forward
# with the plain versions forced at the first (the plain spread of the
# second, rows x taps x channels in float32, is over 10 GB for one call)
LARGE_SIZES = (32768, 98304)
LARGE_REPS = 3


def phase_large(results):
    """``tools.large_cloud_bench`` at LARGE_SIZES on the flagship: zero
    overflow, ms/pair, peak memory and launches; every kernel call of one
    forward at the largest size against its plain version on its inputs;
    at the smallest, the whole flow against the forward with the plain
    versions forced."""
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.tools import large_cloud_bench as lcb
    from hplflownet_tpu_torch.tools.step_calls import check_calls, recorded_calls
    from hplflownet_tpu_torch.tools.timing import model_case
    rows = {}
    for n in LARGE_SIZES:
        row = lcb.run_size(n, DEVICE, reps=LARGE_REPS, warmup=1)
        _require_launches(f"large {n} points", row["launches"])
        rows[n] = row
        log(f"large {n} points: capacities {row['capacities']}, overflow "
            f"{row['overflow']}, {row['ms_per_pair']:.2f} ms/pair (median of "
            f"{LARGE_REPS}, {row['clock']}), peak {row['peak_mib']} MiB, "
            f"launches {row['launches']}")
    per_call, plain = None, None
    for n in (LARGE_SIZES[-1], LARGE_SIZES[0]):
        model, spec, pc1, pc2 = model_case(
            "HPLFlowNet", n, DEVICE, capacities=rows[n]["capacities"],
            cloud_seed=lcb.CLOUD_SEED)
        fn = lcb.forward_fn(model, spec, pc1, pc2)
        if n == LARGE_SIZES[-1]:
            with recorded_calls() as calls:
                fn()
            per_call = check_calls(calls, CALL_TOL)
            del calls
            log(f"large {n} points, every kernel call vs its plain version: "
                + "; ".join(f"{k} {v['calls']} calls at {v['shapes']} shapes, "
                            f"worst {v['worst']:.3e}" for k, v in per_call.items()))
            continue
        flow, _ = fn()
        with plain_kernels():
            want, _ = fn()
        err, rel = _flow_rel(flow, want)
        if rel > FLOW_REL_TOL:
            raise AssertionError(f"large {n} points: bf16 flow, kernels vs plain "
                                 f"max rel {rel:.3e} > {FLOW_REL_TOL}")
        plain = {"points": n, "max_abs": err, "max_rel": rel}
        log(f"large {n} points: bf16 flow, kernels vs plain versions: max abs "
            f"{err:.3e}, max rel {rel:.3e} (limit {FLOW_REL_TOL})")
        del model, fn, flow, want
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    results["large"] = {"sizes": list(rows.values()), "calls": per_call,
                        "plain": plain}


# the segment phase: SPLATNet3D at its published widths (flowbench's
# splatnet3d configuration), one cloud of SEG_POINTS on five lattices of its
# own points halving from 3.0, capacities of flowbench/tools/cloud_capacities.py
SEG_SFM = [[3.0, 1, -1, -1], [1.5, 1, -1, -1], [0.75, 1, -1, -1],
           [0.375, 1, -1, -1], [0.1875, 1, -1, -1]]
SEG_POINTS = 98304
SEG_CAPACITIES = [90240, 30848, 8704, 1920, 512]
SEG_SEED = 7


def segment_launches(n_points: int, capacities) -> dict:
    """What one SPLATNet3D forward launches: a blur (kernel 1), a splat
    (kernel 2) and a slice a BCL, a second kernel-2 pass over the parts
    where the splat's d + 1 = 4 entries a point average
    ``ops.segment.SPLIT`` or more a vertex (``run_sums``), and conv1, conv2
    and the classifier."""
    from hplflownet_tpu_torch.ops.segment import SPLIT
    long = sum(4 * n_points >= SPLIT * c for c in capacities)
    return {"stencil_gather_matmul": len(capacities),
            "rank_reduce": len(capacities) + long, "dense_gemm": 3,
            "slice_points": len(capacities)}


def _segment_model(device):
    """SPLATNet3D in bf16 on seeded weights: Glorot kernels, biases 0.01 z,
    BatchNorm gamma exp(0.25 z), beta and mean 0.1 z, var exp(0.5 z)."""
    import torch
    from hplflownet_tpu_torch.models import SPLATNet3D
    from hplflownet_tpu_torch.models.init import reinit_params
    model = SPLATNet3D(SEG_SFM, compute_dtype="bfloat16", device=device)
    gen = torch.Generator().manual_seed(SEG_SEED)
    state = reinit_params(gen, model.state_dict())
    draw = {"bias": lambda z: 0.01 * z, "gamma": lambda z: torch.exp(0.25 * z),
            "beta": lambda z: 0.1 * z, "mean": lambda z: 0.1 * z,
            "var": lambda z: torch.exp(0.5 * z)}
    for k, v in state.items():
        kind = k.rsplit(".", 1)[1].rsplit("_", 1)[-1]
        if kind in draw:
            state[k] = draw[kind](torch.randn(v.shape, generator=gen)).to(v.device)
    model.load_state_dict(state, strict=True)
    return model


def _segment_cases(calls) -> dict:
    """How many recorded calls are the shapes the segment path adds: kernel
    2's second pass (R = 0 over the parts), ``dense_gemm`` at K = 960 and
    kernel 1's 256 -> 256 blurs."""
    import inspect
    wrappers = _kernel_wrappers()
    found = {"rank_reduce parts": 0, "dense_gemm K=960": 0,
             "stencil_gather_matmul 256->256": 0}
    for name, a, kw, _ in calls:
        args = inspect.signature(wrappers[name]).bind(*a, **kw).arguments
        if name == "rank_reduce" and args["rid"] is None:
            found["rank_reduce parts"] += 1
        elif name == "dense_gemm" and args["x"].shape[1] == 960:
            found["dense_gemm K=960"] += 1
        elif name == "stencil_gather_matmul" and \
                tuple(args["weight"].shape[1:]) == (256, 256):
            found["stencil_gather_matmul 256->256"] += 1
    return found


def phase_segment(results):
    """SPLATNet3D's forward (``pipeline.segment_forward``, bf16) on one
    SEG_POINTS cloud: the launches of kernels 1 and 2 and ``dense_gemm``
    against ``segment_launches``, zero overflow, every kernel call against
    its plain version on its inputs (CALL_TOL; kernel 2's split passes,
    K = 960 and the 256 -> 256 blurs among them), the logits against the
    forward with the plain versions forced, and ms a cloud."""
    import numpy as np
    import torch
    from hplflownet_tpu_torch.kernels import plain_kernels
    from hplflownet_tpu_torch.lattice import build_scales
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.pipeline import make_lattice_spec, segment_forward
    from hplflownet_tpu_torch.tools.step_calls import check_calls, recorded_calls

    pts = synthetic_frustum_clouds(1, SEG_POINTS, seed=0)[0][0]
    spec = make_lattice_spec(SEG_SFM, SEG_CAPACITIES)
    model = _segment_model(DEVICE)

    def fwd():
        return segment_forward(model, spec, pts)
    wrappers = {k: w for k, w in _kernel_wrappers().items()
                if k in FORWARD_KERNELS}
    logits, launches = _counted(wrappers, fwd)
    want = segment_launches(SEG_POINTS, SEG_CAPACITIES)
    log(f"segment launches: {launches} (expected {want})")
    if DEVICE == "cuda" and launches != want:
        raise AssertionError(f"segment forward: launches {launches}, not {want}")
    out = logits.cpu().numpy()
    if out.shape != (SEG_POINTS, 50) or not np.isfinite(out).all():
        raise AssertionError(f"logits shape {out.shape}, finite "
                             f"{bool(np.isfinite(out).all())}")
    with torch.inference_mode():
        scales = build_scales(spec, torch.from_numpy(pts).to(DEVICE))
    overflow = [int(sc.cloud.overflow) for sc in scales]
    vertices = [int(sc.cloud.num_valid) for sc in scales]
    if any(overflow):
        raise AssertionError(f"segment build overflow {overflow}")
    log(f"segment logits {out.shape} finite; vertices per scale {vertices} "
        f"of {SEG_CAPACITIES}, overflow 0")

    with recorded_calls() as calls:
        fwd()
    cases = _segment_cases(calls)
    per_call = check_calls(calls, CALL_TOL)
    del calls
    log("segment, every kernel call vs its plain version: "
        + "; ".join(f"{k} {v['calls']} calls at {v['shapes']} shapes, worst "
                    f"{v['worst']:.3e}" for k, v in per_call.items())
        + f"; among them {cases}")
    need = {"rank_reduce parts": want["rank_reduce"] - len(SEG_CAPACITIES),
            "dense_gemm K=960": 1, "stencil_gather_matmul 256->256": 2}
    if cases != need:
        raise AssertionError(f"segment calls {cases}, not {need}")

    with plain_kernels():
        plain = fwd()
    err, rel = _flow_rel(logits, plain)
    if rel > FLOW_REL_TOL:
        raise AssertionError(f"bf16 logits, kernels vs plain: max rel "
                             f"{rel:.3e} > {FLOW_REL_TOL}")
    log(f"bf16 logits, kernels vs plain versions: max abs {err:.3e}, max rel "
        f"{rel:.3e} (limit {FLOW_REL_TOL})")
    del plain, scales
    ms = cuda_ms(fwd, reps=5, warmup=1)
    log(f"SPLATNet3D forward (five one-cloud builds + model, bf16, host "
        f"points in): {ms:.2f} ms a cloud over 5 reps")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    results["segment"] = {"launches": launches, "calls": per_call,
                          "cases": cases, "vertices": vertices,
                          "max_rel": rel, "ms_per_cloud": ms}


# the slice kernel on the calls of real forwards: name, model, points,
# capacities, which of the forward's slice calls (the flagship slices its
# coarsest scale first): SPLATNet3D's BCL 3 (98304 points onto 8704 x 256,
# no bias), the flagship-98k decoder's up0 (98304 points onto 90752 x 1024,
# bias; flowbench's capacities) and the flagship-8k's up6 (256 points onto
# 128 x 128: the smallest, where one launch saves least)
FLAGSHIP_98K_CAPACITIES = [90752, 72448, 20992, 4736, 1152, 384, 128]
SLICE_CASES = (("SPLATNet3D bcl3", "SPLATNet3D", SEG_POINTS, SEG_CAPACITIES, 2),
               ("flagship-98k up0", "HPLFlowNet", 98304,
                FLAGSHIP_98K_CAPACITIES, 6),
               ("flagship-8k up6", "HPLFlowNet", NUM_POINTS, CAPACITIES, 0))


def _slice_calls(model_name, n_points, capacities):
    """The arguments of every ``slice_points`` call of a bf16 forward on
    synthetic clouds (seed 0), in order."""
    import torch
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.pipeline import (flow_forward, make_lattice_spec,
                                               segment_forward)
    from hplflownet_tpu_torch.tools.step_calls import recorded_calls
    from hplflownet_tpu_torch.tools.timing import model_case
    if model_name == "SPLATNet3D":
        model = _segment_model(DEVICE)
        spec = make_lattice_spec(SEG_SFM, capacities)
        pts = synthetic_frustum_clouds(1, n_points, seed=0)[0][0]

        def fwd():
            return segment_forward(model, spec, pts)
    else:
        model, spec, pc1, pc2 = model_case(model_name, n_points, DEVICE,
                                           capacities=capacities)

        def fwd():
            with torch.inference_mode():
                return flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    with recorded_calls() as calls:
        fwd()
    return [a for name, a, kw, _ in calls if name == "slice_points"]


def phase_slice(results):
    """``slice_points`` (csrc/slice_points.cu) at SLICE_CASES, on the
    arguments real forwards give it, against its plain version (the
    composition the BCL ran before: d + 1 gathers, float32 products and
    sums, bias, cast): equal by ``torch.equal``, a rerun bit for bit, device
    ms (a replayed CUDA graph) and ms through the wrapper, the bytes bound
    (the result written once, each referenced vertex row and the ids and
    weights read once), the plain composition's device ms, which the kernel
    must beat at every case, and ``index_select`` of the point's rows (the
    gather alone, a library yardstick)."""
    import torch
    from hplflownet_tpu_torch.kernels.slice import slice_points, slice_points_plain
    rows, forwards = [], {}
    for name, model_name, n_points, capacities, index in SLICE_CASES:
        key = (model_name, n_points, tuple(capacities))
        if key not in forwards:
            forwards[key] = _slice_calls(model_name, n_points, capacities)
        table, bary, ids, bias, out_dt = forwards[key][index]
        bias = None if bias is None else bias.detach()

        def run():
            return slice_points(table, bary, ids, bias, out_dt)

        def plain():
            return slice_points_plain(table, bary, ids, bias, out_dt)
        got, again, want = run(), run(), plain()
        sync()
        word = torch.int16 if got.element_size() == 2 else torch.int32
        if not torch.equal(got.view(word), again.view(word)):
            raise AssertionError(f"slice_points {name}: rerun differs")
        if not torch.equal(got, want):
            raise AssertionError(f"slice_points {name}: not equal to its plain "
                                 f"version (max abs err "
                                 f"{float((got.float() - want.float()).abs().max()):.3e})")
        (h, c), (n, d1) = table.shape, ids.shape
        present = ids[ids >= 0]
        rows_read = int(torch.unique(present.clamp(max=h - 1)).numel())
        nbytes = (rows_read * c * table.element_size() + n * d1 * 8
                  + n * c * got.element_size() + (0 if bias is None else 4 * c))
        bms, by = bound_ms(nbytes, 2.0 * present.numel() * c, "float32")
        flat = ids.clamp(0, h - 1).reshape(-1)
        row = dict(case=name, dtype="bfloat16",
                   shape=f"N={n} d1={d1} H={h} C={c}"
                         f"{' bias' if bias is not None else ''}",
                   out=str(out_dt).replace("torch.", ""), max_abs_err=0.0,
                   ms=cuda_ms(run), device_ms=device_ms(run), bound_ms=bms,
                   bound_by=by, plain_ms=cuda_ms(plain, reps=3),
                   plain_device_ms=device_ms(plain),
                   library_ms=cuda_ms(lambda: table.index_select(0, flat)),
                   library_device_ms=device_ms(
                       lambda: table.index_select(0, flat)))
        rows.append(row)
        log(f"slice_points {name} ({row['shape']}, {row['out']} out): device "
            f"{row['device_ms']:.4f} ms ({row['ms']:.4f} through the wrapper), "
            f"bound {bms:.4f} ms by {by} ({100 * bms / row['device_ms']:.1f}%), "
            f"plain composition {row['plain_device_ms']:.4f} ms device "
            f"({row['plain_device_ms'] / row['device_ms']:.1f}x), index_select "
            f"{row['library_device_ms']:.4f} ms; equal to plain, rerun bit for bit")
        del table, bary, ids, bias, got, again, want
    del forwards
    slow = [r["case"] for r in rows if r["device_ms"] >= r["plain_device_ms"]]
    if DEVICE == "cuda" and slow:
        raise AssertionError(f"slice_points loses to the plain composition at {slow}")
    if DEVICE == "cuda":
        torch.cuda.empty_cache()
    results["slice"] = rows
    return rows


def phase_native(results):
    """The host builder (``native``, built with g++) against the device
    builder: the 8192-point pair at scale 1.0, every table equal."""
    from hplflownet_tpu_torch.native import check
    res = check.run(DEVICE, NUM_POINTS, scale=1.0)
    results["native"] = res
    log(f"native: host builder == device builder ({res['num_valid']} vertices, "
        f"capacity {res['capacity']}): ids, unique keys, neighbour and "
        f"correlation tables; host ms " + ", ".join(
            f"{k} {v:.2f}" for k, v in res["host_ms"].items())
        + f" ({res['host_ms_total']:.2f} in all, host clock)")


# the lattice phase: the flagship forward (bf16, 8192 points) over two gloo
# ranks on the one card, held to the unsharded flow_forward
LATTICE_CASE = dict(mode="lattice", arch="HPLFlowNet", sfm=SFM7,
                    global_batch=1, data="frustum", seed=0,
                    compute_dtype="bfloat16", steps=4)


def phase_lattice(results):
    """Lattice parallel (``parallel.lattice_sharded_forward``): two gloo
    ranks on the one card (fresh interpreters, ``tools.dryrun_multiprocess``)
    against the unsharded forward (flow, the tap-sharded tables, kernel 1's
    rows per rank), every kernel call of each rank's sharded forward (row
    slices, plans of their own columns) against its plain version at
    CALL_TOL; then one NCCL rank at world size 1, bit for bit."""
    import statistics
    import tempfile
    import torch
    import torch.distributed as dist
    from hplflownet_tpu_torch.kernels.stencil import stencil_gather_matmul
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.parallel import (initialize, lattice_sharded_forward,
                                               make_mesh)
    from hplflownet_tpu_torch.pipeline import flow_forward
    from hplflownet_tpu_torch.tools import dryrun_multiprocess as dryrun
    from torch.utils.flop_counter import FlopCounterMode
    case = dict(LATTICE_CASE, num_points=NUM_POINTS, capacities=CAPACITIES,
                call_tol=CALL_TOL)
    with tempfile.TemporaryDirectory() as tmp:
        res = dryrun.run(case, procs=2, device=DEVICE, backend="gloo",
                         save_dir=tmp, timeout=600)
        ranks = [torch.load(os.path.join(tmp, f"rank{i}.pt"), map_location="cpu")
                 for i in range(2)]
    for i, launches in enumerate(res["launches"]):            # a forward
        _require_launches(f"lattice rank {i}", {k: launches[k] for k in
                                                FORWARD_KERNELS})

    model, spec, batch = dryrun.make_case(case, DEVICE)
    pc1, pc2 = (torch.from_numpy(batch[k][0]).to(DEVICE) for k in ("pc1", "pc2"))
    stencil_gather_matmul.rows = 0

    def whole():
        return flow_forward(model, spec, pc1, pc2, adjoint_plans=False)
    want, launches = _counted(_kernel_wrappers(), whole)
    rows = stencil_gather_matmul.rows
    exact = torch.equal(ranks[0]["flow"], want.cpu())
    err, rel = _flow_rel(ranks[0]["flow"], want.cpu())
    if not exact and rel > FLOW_REL_TOL:
        raise AssertionError(f"lattice: sharded flow vs unsharded max rel "
                             f"{rel:.3e} > {FLOW_REL_TOL}")
    with torch.inference_mode():
        scales = build_pyramid(spec, pc1, pc2, adjoint_plans=False)
    differ = [k for k, t in ranks[0]["tables"].items()
              if not torch.equal(t, getattr(scales[int(k.split(".")[0])],
                                            k.split(".")[1]).cpu())]
    if differ:
        raise AssertionError(f"lattice: tap-sharded tables differ: {differ[:5]}")
    # each of a rank's kernel-1 calls computes ceil(H / 2) of its H rows
    n_calls = launches["stencil_gather_matmul"]
    for i, r in enumerate(res["kernel1_rows"]):
        if DEVICE == "cuda" and not (0 < 2 * r <= rows + n_calls
                                     and res["launches"][i]["stencil_gather_matmul"]
                                     == n_calls):
            raise AssertionError(f"lattice rank {i}: kernel 1 computed {r} rows "
                                 f"in {res['launches'][i]} launches; unsharded "
                                 f"{rows} rows in {n_calls}")
    # each rank's kernel calls were replayed against their plain versions
    for i, per_call in enumerate(res["calls"]):
        missing = [k for k in FORWARD_KERNELS
                   if per_call.get(k, {}).get("calls", 0) <= 0]
        if missing:
            raise AssertionError(f"lattice rank {i}: no call of {missing} "
                                 f"checked against its plain version")
    # timed as the ranks time theirs: each call alone on the host clock up
    # to a synchronise, the median after the first
    whole_ms = statistics.median(dryrun.host_ms(whole, DEVICE)[1]
                                 for _ in range(LATTICE_CASE["steps"] - 1))
    with FlopCounterMode(display=False) as counter:
        whole()
    flops = counter.get_total_flops()

    dev = initialize(coordinator_address=f"127.0.0.1:{dryrun.free_port()}",
                     num_processes=1, process_id=0,
                     device="cpu" if DEVICE == "cpu" else None, timeout=300)
    try:
        backend = dist.get_backend()
        fn = lattice_sharded_forward(model, spec, make_mesh(axis_names=("lattice",)))
        one = fn(None, pc1.to(dev), pc2.to(dev))
    finally:
        dist.destroy_process_group()
    if not torch.equal(one, want):
        raise AssertionError(f"lattice: {backend} at world size 1 is not "
                             f"flow_forward bit for bit")
    results["lattice"] = dict(
        exact=exact, max_abs=err, max_rel=rel, launches=res["launches"],
        kernel1_rows=res["kernel1_rows"], unsharded_rows=rows,
        unsharded_launches=launches, flops=res["flops"], unsharded_flops=flops,
        calls=res["calls"], sharded_ms=res["step_ms"],
        first_ms=res["first_step_ms"], unsharded_ms=whole_ms,
        backend_one=backend, elapsed_s=res["elapsed_s"])
    log(f"lattice: two gloo ranks on {res['device']} (flagship bf16, "
        f"{NUM_POINTS} points): flow {'bit for bit' if exact else 'within'} "
        f"the unsharded one (max abs {err:.3e}, max rel {rel:.3e}); tap-sharded "
        f"tables equal; kernel 1 rows per rank {res['kernel1_rows']} of "
        f"{rows} unsharded in {n_calls} launches; FLOPs per rank {res['flops']} "
        f"of {flops} unsharded ({res['flops'][0] / flops:.3f}); "
        f"ms/pair per rank {res['step_ms']} vs unsharded {whole_ms:.2f} (host "
        f"clock up to a synchronise; ranks share the card and gather through "
        f"host memory: no scaling figure); {backend} at world size 1 bit for "
        f"bit")
    for i, per_call in enumerate(res["calls"]):
        log(f"lattice rank {i}, every kernel call vs its plain version "
            f"(limits: bf16 out {CALL_TOL['bf16']}, float32 out "
            f"{CALL_TOL['f32']}): " + "; ".join(
                f"{k} {v['calls']} calls at {v['shapes']} shapes, worst "
                f"{v['worst']:.3e}" for k, v in per_call.items()))


def phase_plans(results):
    """The CUDA kernels one pair's stencil plans launch, counted with
    torch.profiler; last, because the profiler's tracing slows the host
    for the rest of the process."""
    import torch
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.pipeline import make_lattice_spec
    pc1, pc2 = synthetic_frustum_clouds(1, NUM_POINTS, seed=0)
    with torch.inference_mode():
        scales = build_pyramid(make_lattice_spec(SFM7, CAPACITIES),
                               torch.from_numpy(pc1[0]).to(DEVICE),
                               torch.from_numpy(pc2[0]).to(DEVICE))
    plans = results.setdefault("plans", {})
    plans.update(plan_kernels(scales))
    log(f"stencil plans: {plans.get('builds_forward')} per forward, "
        f"{plans.get('builds_step')} per train step; CUDA kernels of one "
        f"pair's plans: {plans['kernels_forward']} (forward, row orders), "
        f"{plans['kernels_step']} (train step, with the vertex lists)")


# the fused_build phase: the HPL_FUSED_BUILD values held against "0" (every
# scale fused; the flagship's scales of capacity <= 3584, its four coarse
# ones), the timed ones, and the reps of each timing
FUSED_BUILD_MODES = ("1", "3584")
FUSED_BUILD_TIMED = ("0", "1", "3584")
FUSED_BUILD_REPS = 5
FUSED_BUILD_ARCH = "HPLFlowNet"   # the timed model (a CPU rehearsal: the shallow one)


def _pyramid_fields(scales) -> dict:
    """Every ScalePair field of a pyramid (splat plans field by field)."""
    out = {}
    for i, s in enumerate(scales):
        for name, v in zip(s._fields, s):
            if name.endswith("splat_plan"):
                out.update({f"{i}.{name}.{k}": t for k, t in zip(v._fields, v)})
            else:
                out[f"{i}.{name}"] = v
    return out


def _same(what: str, got: dict, want: dict) -> int:
    """Raise unless the two dicts of tensors are equal bit for bit."""
    import torch
    differ = [k for k in want if got[k].dtype != want[k].dtype
              or not torch.equal(got[k], want[k])]
    if differ or set(got) != set(want):
        raise AssertionError(f"{what}: {len(differ)} of {len(want)} fields "
                             f"differ: {differ[:5]}")
    return len(want)


def phase_fused_build(results):
    """``HPL_FUSED_BUILD`` (both clouds of a scale built from one sort and
    probed in one join): every table of the flagship and the shallow
    model's pyramids under each of FUSED_BUILD_MODES, and the flagship
    flow and one train step's loss and gradients under the first, bit for
    bit against "0";
    ``pipeline.batched_flow_forward`` against per-sample ``flow_forward``;
    then ``tools.fused_build_bench`` in a fresh interpreter (the profiler
    of the phases before slows this one's host): build, forward and step ms
    with the modes in turns, and kernels per forward and per step."""
    import tempfile
    import numpy as np
    import torch
    from hplflownet_tpu_torch.lattice import build_pyramid
    from hplflownet_tpu_torch.lattice.capacity import synthetic_frustum_clouds
    from hplflownet_tpu_torch.models import HPLFlowNet
    from hplflownet_tpu_torch.params import params_from_jax, seeded_jax_params
    from hplflownet_tpu_torch.pipeline import (batched_flow_forward, flow_forward,
                                               make_lattice_spec)
    from hplflownet_tpu_torch.tools.fused_build_bench import fused_build
    from hplflownet_tpu_torch.train.step import loss_and_grad

    pcs = synthetic_frustum_clouds(2, NUM_POINTS, seed=0)
    pc1, pc2 = (torch.from_numpy(p[0]).to(DEVICE) for p in pcs)
    fields = 0
    for name, sfm, caps in (("flagship", SFM7, CAPACITIES),
                            ("shallow", SFM5, SHALLOW_CAPACITIES)):
        spec = make_lattice_spec(sfm, caps)
        tables = {}
        for mode in ("0",) + FUSED_BUILD_MODES:
            with fused_build(mode), torch.inference_mode():
                tables[mode] = _pyramid_fields(build_pyramid(spec, pc1, pc2))
        for mode in FUSED_BUILD_MODES:
            fields += _same(f"{name} tables, HPL_FUSED_BUILD={mode} vs 0",
                            tables[mode], tables["0"])
    del tables

    spec = make_lattice_spec(SFM7, CAPACITIES)
    model = HPLFlowNet(SFM7, compute_dtype="bfloat16", device=DEVICE)
    params_from_jax(seeded_jax_params(model, 0), model)
    params = dict(model.named_parameters())
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in dict(
        pc1=pcs[0][:1], pc2=pcs[1][:1], sf=pcs[1][:1] - pcs[0][:1],
        valid1=np.ones((1, NUM_POINTS), bool),
        valid2=np.ones((1, NUM_POINTS), bool)).items()}
    out, launches = {}, {}
    for mode in ("0", FUSED_BUILD_MODES[0]):
        with fused_build(mode):
            flow, launches[f"forward_{mode}"] = _counted(
                _kernel_wrappers(),
                lambda: flow_forward(model, spec, pc1, pc2, adjoint_plans=False))
            (loss, overflow, grads), launches[f"step_{mode}"] = _counted(
                _kernel_wrappers(),
                lambda: loss_and_grad(model, spec, params, batch))
        if int(overflow) != 0:
            raise AssertionError(f"HPL_FUSED_BUILD={mode}: overflow {int(overflow)}")
        out[mode] = dict(flow=flow, loss=loss, **{f"grad {k}": g
                                                   for k, g in grads.items()})
    mode = FUSED_BUILD_MODES[0]
    _require_launches(f"forward, HPL_FUSED_BUILD={mode}",
                      {k: launches[f"forward_{mode}"][k]
                       for k in FORWARD_KERNELS})
    _require_launches(f"train step, HPL_FUSED_BUILD={mode}", launches[f"step_{mode}"])
    _same(f"flagship flow, loss and gradients, HPL_FUSED_BUILD={mode} vs 0",
          out[mode], out["0"])
    n_leaves = len(out["0"]) - 2
    del out

    # a batch of two pairs, some points invalid in each cloud
    b1 = torch.from_numpy(pcs[0]).to(DEVICE)
    b2 = torch.from_numpy(pcs[1]).to(DEVICE)
    v1 = torch.ones((2, NUM_POINTS), dtype=torch.bool, device=DEVICE)
    v2 = v1.clone()
    v1[0, ::7] = False
    v2[1, 3::5] = False
    batched = batched_flow_forward(model, spec, b1, b2, v1, v2)
    single = torch.stack([flow_forward(model, spec, b1[i], b2[i], v1[i], v2[i])
                          for i in range(2)])
    if batched.shape != (2, NUM_POINTS, 3) or not torch.equal(batched, single):
        raise AssertionError(f"batched_flow_forward {tuple(batched.shape)} is "
                             f"not per-sample flow_forward bit for bit")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fused_build.json")
        caps = (CAPACITIES if FUSED_BUILD_ARCH == "HPLFlowNet"
                else SHALLOW_CAPACITIES)
        cmd = [sys.executable, "-m", "hplflownet_tpu_torch.tools.fused_build_bench",
               "--modes", ",".join(FUSED_BUILD_TIMED), "--arch", FUSED_BUILD_ARCH,
               "--points", str(NUM_POINTS), "--capacities", ",".join(map(str, caps)),
               "--reps", str(FUSED_BUILD_REPS), "--out", path]
        if DEVICE == "cpu":
            cmd += ["--device", "cpu"]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"fused_build_bench exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        with open(path) as fd:
            bench = json.load(fd)
    results["fused_build"] = dict(fields=fields, leaves=n_leaves,
                                  launches=launches, bench=bench)
    log(f"fused build: {fields} table fields of the flagship and shallow "
        f"pyramids under HPL_FUSED_BUILD={'/'.join(FUSED_BUILD_MODES)} equal "
        f"to 0's; the flagship flow, loss and {n_leaves} gradient leaves under "
        f"{mode} bit for bit; kernels 1-4 launched {launches[f'step_{mode}']} "
        f"in its step; batched_flow_forward (2 pairs, some points invalid) == "
        f"per-sample flow_forward bit for bit")
    for k in ("build_ms", "forward_ms", "step_ms"):
        log(f"fused build {k} in turns {bench['order']}: " + "; ".join(
            f"{m} {np.round(v, 3).tolist()}" for m, v in bench[k].items()))
    log(f"fused build: build_pyramid operators {bench['build_ops_forward']} "
        f"(the forward's), {bench['build_ops_step']} (with the adjoint plans); "
        f"device kernels per forward {bench['launches_forward']}, per step "
        f"{bench['launches_step']} ({bench['card']}, {bench['clock']})")


def kernels_line(results) -> dict:
    """The contract line: one entry per kernel, at its widest bf16 case."""
    def pick(kind, case):
        return [r for r in results[kind]
                if r["case"].startswith(case) and r["dtype"] == "bfloat16"][0]
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    stencil = "hplflownet_tpu/ops/pallas_stencil.py"
    train, fwd = results["launches"], results.get("forward_launches", {})
    fused = results.get("fused_launches", {})
    fused_fwd = results.get("fused_forward_launches", {})
    tools = results.get("tools_launches", {})
    # name, result kind, case, replaced TPU kernel, launches (path's run),
    # launches on the forward where there is one
    entries = [
        ("stencil_gather_matmul", "stencil", "bcn1_ decoder blur",
         f"{stencil}:270", train, fwd),
        ("rank_reduce", "reduce", "scale-2", f"{stencil}:735", train, fwd),
        ("stencil_dkernel", "dkernel", "bcn1_ blur dW", f"{stencil}:340",
         train, fwd),
        ("stencil_tap_tables_sum", "tap_tables", "corr1", f"{stencil}:461",
         train, fwd),
        ("blocked_rank_reduce", "fused", "scale-2 splat", f"{stencil}:648",
         fused, fused_fwd),
        ("row_take", "take", "gather lab", "tools/gather_experiments.py:76",
         tools, {}),
        ("rank_partial", "partial", "lab bo=8", "tools/rank_partial_lab.py:110",
         tools, {}),
        ("dense_gemm", "dense", "conv2", "none (XLA's dot, "
         "hplflownet_tpu/ops/bcl.py:416)", train, fwd),
        ("slice_points", "slice", "SPLATNet3D bcl3", "none (XLA's gathers, "
         "hplflownet_tpu/ops/bcl.py:290)", train, fwd),
    ]
    out = []
    for name, kind, case, replaces, launches, launches_fwd in entries:
        row = pick(kind, case)
        out.append(dict(
            name=name, route="cuda",
            source=f"hplflownet_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=launches[name],
            **{k: row[k] for k in keys},
            **{k: row[k] for k in ("device_ms", "library_device_ms",
                                   "plain_device_ms") if k in row},
            shape=row["shape"] + " bf16",
            max_abs_err_all=max(r["max_abs_err"] for r in results[kind]),
            **({"launches_forward": launches_fwd[name]}
               if name in launches_fwd else {})))
    # the slice kernel at each of its cases: device ms, bound, plain device ms
    for row in out:
        if row["name"] == "slice_points":
            row["cases"] = {r["case"]: {k: r[k] for k in (
                "shape", "device_ms", "bound_ms", "plain_device_ms")}
                for r in results["slice"]}
    # the later paths' launches, each counted over its own run
    shallow, driver = results.get("shallow", {}), results.get("driver", {})
    dp, synthetic = results.get("dp", {}), results.get("synthetic", {})
    bench = results.get("bench", {}).get("launches", {})
    large = {f"launches_large_{r['points']}": r["launches"]
             for r in results.get("large", {}).get("sizes", [])}
    large_calls = results.get("large", {}).get("calls") or {}
    lattice = results.get("lattice", {})
    fused_build = results.get("fused_build", {}).get("launches", {})
    for row in out:
        for key, counts in large.items():
            if row["name"] in counts:
                row[key] = counts[row["name"]]
        if row["name"] in large_calls:
            row["max_rel_err_large_calls"] = large_calls[row["name"]]["worst"]
        if lattice and row["name"] in lattice["launches"][0]:
            row["launches_lattice_rank0"] = lattice["launches"][0][row["name"]]
    for row in out:
        for key, counts in (
                ("launches_shallow_step", shallow.get("step_launches", {})),
                ("launches_shallow_forward", shallow.get("forward_launches", {})),
                ("launches_segment", results.get("segment", {}).get("launches", {})),
                ("launches_driver_train", driver.get("train_launches", {})),
                ("launches_driver_eval", driver.get("eval_launches", {})),
                ("launches_dp_rank0", (dp.get("launches") or [{}])[0]),
                ("launches_dp_world1", dp.get("nccl_launches", {})),
                ("launches_bench_step", bench.get("step", {})),
                ("launches_bench_forward", bench.get("forward", {})),
                ("launches_synthetic_train", synthetic.get("train_launches", {})),
                ("launches_synthetic_eval", synthetic.get("eval_launches", {})),
                ("launches_fused_build_forward",
                 fused_build.get(f"forward_{FUSED_BUILD_MODES[0]}", {})),
                ("launches_fused_build_step",
                 fused_build.get(f"step_{FUSED_BUILD_MODES[0]}", {}))):
            if row["name"] in counts:
                row[key] = counts[row["name"]]
    return {"kernels": out}


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description="Smoke run of hplflownet_tpu_torch "
                                 "on one CUDA card (see the module's note)")
    ap.add_argument("--phases", default=None,
                    help="run only these phases, comma-separated (e.g. "
                    "device,build,kernels), and end with their results "
                    "instead of the kernels line")
    ap.add_argument("--out", default=None,
                    help="also write the phases' results as JSON to this file")
    args = ap.parse_args(argv)
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

    def sampled(phase):
        with SmiSampler() as smi:
            phase(results)
        results["smi_kernels"] = smi.summary()
        log(f"nvidia-smi during the kernel phase (min, max): "
            f"{results['smi_kernels']}")

    phases = [("device", phase_device), ("build", phase_build),
              ("kernels", lambda: sampled(phase_kernels)),
              ("dense", lambda: phase_dense(results)),
              ("slice", lambda: phase_slice(results)),
              ("reference", phase_reference),
              ("main path", lambda: phase_main_path(results)),
              ("train", lambda: phase_train(results)),
              ("fused", lambda: phase_fused(results)),
              ("shallow", lambda: phase_shallow(results)),
              ("driver", lambda: phase_driver(results)),
              ("tools", lambda: phase_tools(results)),
              ("bench", lambda: phase_bench(results)),
              ("synthetic", lambda: phase_synthetic(results)),
              ("large", lambda: phase_large(results)),
              ("segment", lambda: phase_segment(results)),
              ("native", lambda: phase_native(results)),
              ("dp", lambda: phase_dp(results)),
              ("lattice", lambda: phase_lattice(results)),
              ("plans", lambda: phase_plans(results)),
              ("fused_build", lambda: phase_fused_build(results))]
    only = None if args.phases is None else args.phases.split(",")
    if only is not None and set(only) - {n for n, _ in phases}:
        print(f"chip_smoke: unknown phases {sorted(set(only) - {n for n, _ in phases})}",
              file=sys.stderr)
        return 2
    outputs = {}
    for i, (name, fn) in enumerate(phases, 1):
        if only is not None and name not in only:
            continue
        t = time.perf_counter()
        try:
            outputs[name] = fn()
        except Exception:
            traceback.print_exc()
            log(f"phase {i} {name}: FAILED after {time.perf_counter() - t:.1f} s")
            return 1
        log(f"phase {i} {name}: ok in {time.perf_counter() - t:.1f} s")
        if name == "device":
            results["card"] = outputs[name][1]

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fd:
            json.dump(results, fd, indent=1)
    kind, smi_line = outputs["device"] if "device" in outputs else phase_device()
    if only is None:
        print(json.dumps(kernels_line(results)), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
