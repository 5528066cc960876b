"""SPLATNet3D in plain float32 PyTorch, with its work log.

The segmentation network of Su et al., "SPLATNet: Sparse Lattice Networks
for Point Cloud Processing" (CVPR 2018, Fig. 3; github.com/NVlabs/splatnet),
as functions of a parameter dict named as the measured program names its
``state_dict``:

* ``conv1``: a 1x1 conv of ``embed_width`` channels on the points' xyz;
* ``bcl1`` .. ``bcl5``: BCL k splats the points' features onto the cloud's
  own lattice at row k of ``scales_filter_map`` (each scale elevated from
  the points themselves, :func:`build_scales`), blurs over the 15-tap
  1-neighbourhood (``conv0_kernel`` of shape (taps, C_in, C_out), plus
  ``conv0_bias``) and slices back to every point;
* BatchNorm (``<layer>_bn``: ``gamma * (x - mean) / sqrt(var + 1e-5) +
  beta`` over the points, from its running statistics) and ReLU after
  every conv and BCL but the classifier;
* the BCL outputs concatenated, ``conv2`` (``head_width``), ``conv3``
  (``classes``: the logits).

Every product and sum is float32; TF32 is the configuration's (off).  The
lattice, splat, blur, slice and dense products are ``lattice.py``'s and
``model.py``'s, so the work log holds ``splat``, ``stencil`` (op
``blur``), ``slice`` and ``dense`` entries; BatchNorm logs its own
``flops`` (kind ``batchnorm``: the subtract, scale, multiply and add per
value).  ``q`` rounds every operand of a product, as in ``model.py``.

Where it departs from the paper (each also in the configuration's
``assumed``):

* lattice scales are in the cloud's own units (metres):
  ``scales_filter_map``'s rows, 3.0 halving per BCL, where the paper
  scales normalised shapes by 64;
* the splat is normalised by each vertex's summed barycentric weight +
  1e-5 (the port's BCL), before the blur;
* each BCL's one bias is on the blur, before the slice;
* BatchNorm is inference's affine of drawn running statistics; no dropout;
* vertices past a scale's static capacity are dropped (id -1) and the
  points whose keys leave the packed range are left out, as the program's
  build does; the benchmark's clouds overflow neither.
"""

from __future__ import annotations

import math

import torch

from . import lattice
from .model import _Ctx, _dense, _slice, _splat, _stencil

__all__ = ["param_shapes", "init_params", "build_scales", "forward", "BN_EPS"]

BN_EPS = 1e-5
_BN = ("gamma", "beta", "mean", "var")


def _norms(cfg) -> dict:
    """BatchNorm name -> channels."""
    out = {"conv1_bn": cfg["embed_width"]}
    out.update({f"bcl{k}_bn": w for k, w in enumerate(cfg["bcl_widths"], 1)})
    out["conv2_bn"] = cfg["head_width"]
    return out


def param_shapes(cfg) -> dict:
    """Parameter (and BatchNorm statistic) name -> shape."""
    d, e, h = cfg["dim"], cfg["embed_width"], cfg["head_width"]
    ws = cfg["bcl_widths"]
    shapes = {"conv1.dense0_kernel": (d, e), "conv1.dense0_bias": (e,)}
    c_in = e
    for k, (row, w) in enumerate(zip(cfg["scales_filter_map"], ws), 1):
        taps = lattice.filter_size(int(row[1]), d)
        shapes[f"bcl{k}.conv0_kernel"] = (taps, c_in, w)
        shapes[f"bcl{k}.conv0_bias"] = (w,)
        c_in = w
    shapes.update({"conv2.dense0_kernel": (sum(ws), h), "conv2.dense0_bias": (h,),
                   "conv3.dense0_kernel": (h, cfg["classes"]),
                   "conv3.dense0_bias": (cfg["classes"],)})
    for name, c in _norms(cfg).items():
        shapes.update({f"{name}.{s}": (c,) for s in _BN})
    return shapes


def init_params(cfg, seed: int, device) -> dict:
    """Seeded parameters, made on ``device`` in one normal draw ``z``, names
    in sorted order taking consecutive slices: kernels Glorot-normal (the
    stencil axis counted into both fans), biases ``0.01 z``; BatchNorm
    ``gamma = exp(0.25 z)``, ``beta = 0.1 z``, ``mean = 0.1 z``, ``var =
    exp(0.5 z)``, so that a program that skips it reads far off."""
    shapes = param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    out = {}
    for k, z in zip(names, torch.split(flat, sizes)):
        shape, kind = shapes[k], k.rsplit(".", 1)[1]
        if kind.endswith("kernel"):
            field = math.prod(shape[:-2]) if len(shape) > 2 else 1
            v = z * math.sqrt(2.0 / ((shape[-2] + shape[-1]) * field))
        elif kind == "gamma":
            v = torch.exp(0.25 * z)
        elif kind == "var":
            v = torch.exp(0.5 * z)
        elif kind in ("beta", "mean"):
            v = 0.1 * z
        else:
            v = 0.01 * z
        out[k] = v.view(shape)
    return out


def build_scales(cfg, capacities, points: torch.Tensor,
                 valid: torch.Tensor | None = None) -> list:
    """(cloud, blur table) per row of ``scales_filter_map``, each scale
    elevated from ``points`` themselves."""
    d = points.shape[1]
    if valid is None:
        valid = torch.ones(points.shape[0], dtype=torch.bool, device=points.device)
    out = []
    for row, cap in zip(cfg["scales_filter_map"], capacities):
        c = lattice._cloud(lattice.elevate(points, float(row[0])), valid, cap)
        offs = lattice.neighborhood_offsets(int(row[1]), d)
        out.append((c, lattice._stencil(c, c, offs)))
    return out


def _bn_relu(ctx, p, name, x):
    ctx.record(kind="batchnorm", flops=4.0 * x.numel())
    y = p[f"{name}.gamma"] * (x - p[f"{name}.mean"]) \
        / torch.sqrt(p[f"{name}.var"] + BN_EPS) + p[f"{name}.beta"]
    return torch.relu(y)


def forward(cfg, capacities, params: dict, points: torch.Tensor,
            valid: torch.Tensor | None = None, q=None,
            log: list | None = None) -> torch.Tensor:
    """(N, classes) float32 logits of the (N, 3) cloud ``points``."""
    ctx = _Ctx(q, log)
    p = params
    points = points.to(torch.float32)
    scales = build_scales(cfg, capacities, points, valid)
    rows = scales[0][0].num_points
    x = _bn_relu(ctx, p, "conv1_bn", _dense(ctx, points, p["conv1.dense0_kernel"],
                                            p["conv1.dense0_bias"], rows))
    outs = []
    for k, (cloud, blur) in enumerate(scales, 1):
        v = _splat(ctx, x, cloud, cloud.coords.shape[0])
        v = _stencil(ctx, v, blur, p[f"bcl{k}.conv0_kernel"], "blur",
                     cloud.num_valid) + p[f"bcl{k}.conv0_bias"]
        x = _bn_relu(ctx, p, f"bcl{k}_bn", _slice(ctx, v, cloud))
        outs.append(x)
    h = _bn_relu(ctx, p, "conv2_bn", _dense(ctx, torch.cat(outs, dim=1),
                                            p["conv2.dense0_kernel"],
                                            p["conv2.dense0_bias"], rows))
    return _dense(ctx, h, p["conv3.dense0_kernel"], p["conv3.dense0_bias"], rows)
