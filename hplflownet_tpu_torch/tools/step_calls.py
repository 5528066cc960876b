"""The calls one flagship forward and one train step make to two kernels.

:func:`record` replaces, for the length of a ``with`` block, the names
through which the ops call ``rank_reduce`` (``ops.segment``) and
``stencil_tap_tables_sum`` (``ops.corr``) with recorders that pass every
call on unchanged and group the calls by shape.  :func:`flagship_calls`
runs the flagship's forward (``pipeline.flow_forward``) and one train step
(``train.step.make_train_step``: batch 1, Adam, overflow skip) under it and
returns, per kernel, every distinct shape with its launches per forward and
per step and the arguments of its first call in the step, so that a kernel
can be timed on the inputs the step really gives it.

:class:`recorded_calls` records every call the ops make to kernels 1-4
with a copy of its output, and :func:`check_calls` runs each again with
the plain versions forced and holds the two to a limit.

``chip_smoke.py``, ``tools.kernel_ab`` and the lattice mode of
``tools.dryrun_multiprocess`` use this module; the model never reads it.
"""

from __future__ import annotations

import contextlib
import inspect

import numpy as np
import torch

from .timing import CAPACITIES, NUM_POINTS, SFM7

__all__ = ["KERNELS", "SITES", "shape_key", "record", "recorded_calls",
           "check_calls", "flagship_calls"]

# kernel name -> (module whose global the ops call it through, wrapper path)
KERNELS = {"rank_reduce": "hplflownet_tpu_torch.ops.segment",
           "stencil_tap_tables_sum": "hplflownet_tpu_torch.ops.corr"}

# where the ops call each kernel of the main path (module globals)
SITES = {"stencil_gather_matmul": ("ops.bcl", "ops.corr"),
         "rank_reduce": ("ops.segment",),
         "stencil_dkernel": ("ops.bcl", "ops.corr"),
         "stencil_tap_tables_sum": ("ops.corr",)}


def shape_key(name: str, args: dict) -> dict:
    """What sets a call's shape: ``rank_reduce`` (M, C, R, T, with_weights,
    dtype), ``stencil_tap_tables_sum`` (H, F, C, H_out, dtype)."""
    if name == "rank_reduce":
        g, c = args["g"], args["c"]
        r = 0 if args["rid"] is None else g.shape[1] - c
        return dict(M=g.shape[0], C=c, R=r, T=args["start"].shape[0],
                    with_weights=bool(args["with_weights"]),
                    dtype=str(g.dtype).replace("torch.", ""))
    tables, nb = args["tables"], args["neighbors"]
    return dict(H=tables.shape[0], F=nb.shape[0], C=args["c"], H_out=nb.shape[1],
                dtype=str(tables.dtype).replace("torch.", ""))


@contextlib.contextmanager
def record(names=tuple(KERNELS)):
    """Record the ops' calls to the named kernels: yields ``{name: [group,
    ...]}``, each group ``{"key": shape_key, "launches": n, "args": {...}}``
    (the first call's arguments by parameter name), in order of first call."""
    import importlib
    found = {n: [] for n in names}
    saved = []
    try:
        for name in names:
            mod = importlib.import_module(KERNELS[name])
            wrapper = getattr(mod, name)
            sig = inspect.signature(wrapper)

            def recorder(*a, _name=name, _wrapper=wrapper, _sig=sig, **kw):
                bound = _sig.bind(*a, **kw)
                bound.apply_defaults()
                args = dict(bound.arguments)
                key = shape_key(_name, args)
                groups = found[_name]
                for grp in groups:
                    if grp["key"] == key:
                        grp["launches"] += 1
                        break
                else:
                    groups.append(dict(key=key, launches=1, args=args))
                return _wrapper(*a, **kw)
            saved.append((mod, name, wrapper))
            setattr(mod, name, recorder)
        yield found
    finally:
        for mod, name, wrapper in saved:
            setattr(mod, name, wrapper)


class recorded_calls:
    """Within the ``with``, every call the ops make to kernels 1-4 is
    passed on and recorded as (name, args, kwargs, a copy of the output)."""

    def __enter__(self):
        import importlib
        self.calls, self.saved = [], []
        for name, sites in SITES.items():
            for site in sites:
                mod = importlib.import_module(f"hplflownet_tpu_torch.{site}")
                wrapper = getattr(mod, name)

                def recorder(*a, _name=name, _wrapper=wrapper, **kw):
                    out = _wrapper(*a, **kw)
                    self.calls.append((_name, a, kw, out.detach().clone()))
                    return out
                self.saved.append((mod, name, wrapper))
                setattr(mod, name, recorder)
        return self.calls

    def __exit__(self, *exc):
        for mod, name, wrapper in self.saved:
            setattr(mod, name, wrapper)


def check_calls(calls, tol: dict) -> dict:
    """Each recorded call again with the plain versions forced: -> per
    kernel the number of calls and shapes and the worst max|d| /
    max|plain|; raises past ``tol`` (``{"bf16": x, "f32": y}``, by the
    output's dtype) or on a shape that differs."""
    from ..kernels import main_path_wrappers, plain_kernels
    wrappers = main_path_wrappers()
    out = {}
    for name, a, kw, got in calls:
        with plain_kernels(), torch.no_grad():
            want = wrappers[name](*a, **kw)
        limit = tol["bf16" if got.dtype == torch.bfloat16 else "f32"]
        d = float((got.float() - want.float()).abs().max()
                  / want.float().abs().max().clamp_min(1e-30))
        shape = (tuple(got.shape), str(got.dtype))
        if d > limit or got.shape != want.shape:
            raise AssertionError(f"{name} call at output {shape}: max|d| / "
                                 f"max|plain| {d:.3e} > {limit}")
        row = out.setdefault(name, {"calls": 0, "shapes": set(), "worst": 0.0})
        row["calls"] += 1
        row["shapes"].add(shape)
        row["worst"] = max(row["worst"], d)
    for row in out.values():
        row["shapes"] = len(row["shapes"])
    return out


def flagship_calls(device, num_points: int = NUM_POINTS,
                   capacities=CAPACITIES, dtype: str = "bfloat16",
                   seed: int = 0, names=tuple(KERNELS)) -> dict:
    """One flagship forward and one train step on ``device`` (seeded
    weights, the synthetic pair of ``seed``), recorded: ``{name: [{"key":
    ..., "launches_step": n, "launches_forward": n, "args": {...}}, ...]}``
    with the step's arguments, in order of first call in the step."""
    from ..lattice.capacity import synthetic_frustum_clouds
    from ..models import HPLFlowNet
    from ..params import params_from_jax, seeded_jax_params
    from ..pipeline import flow_forward, make_lattice_spec
    from ..train.step import make_train_step
    dev = torch.device(device)
    pc1, pc2 = synthetic_frustum_clouds(1, num_points, seed=seed)
    spec = make_lattice_spec(SFM7, capacities)
    model = HPLFlowNet(SFM7, compute_dtype=dtype, device=dev)
    params_from_jax(seeded_jax_params(model, seed), model)
    ones = np.ones((1, num_points), bool)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in dict(
        pc1=pc1, pc2=pc2, sf=pc2 - pc1, valid1=ones, valid2=ones).items()}
    init, step = make_train_step(model, spec, learning_rate=1e-4,
                                 on_overflow="skip", device=dev)
    with record(names) as fwd:
        flow_forward(model, spec, pc1[0], pc2[0], adjoint_plans=False)
    with record(names) as stp:
        step.with_overflow(init(), batch)
    out = {}
    for name in names:
        per_fwd = [(g["key"], g["launches"]) for g in fwd[name]]
        out[name] = [dict(key=g["key"], launches_step=g["launches"],
                          launches_forward=sum(n for k, n in per_fwd
                                               if k == g["key"]),
                          args=g["args"]) for g in stp[name]]
    return out
