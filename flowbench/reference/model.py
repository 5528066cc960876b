"""HPLFlowNet and HPLFlowNetShallow in plain float32 PyTorch.

The forward pass of Gu et al. (CVPR 2019; github.com/laoreja/HPLFlowNet
``models/HPLFlowNet.py``, ``models/HPLFlowNet_shallow.py``) over a
:mod:`.lattice` pyramid, as functions of a parameter dict named as the
measured program names its ``state_dict`` (the flax names: ``bcn1.conv0_kernel``
of shape (taps, C_in, C_out), ``conv1.dense0_kernel`` of shape (in, out)):

* splat: barycentric-weighted sums of point features on the lattice
  vertices (``index_add``), divided by the summed weights + 1e-5;
* blur: ``sum_f x[nb[f, v]] @ W[f]`` over the stencil, from the
  materialised (H, F, C) spread;
* slice: each point's d+1 vertex features, barycentric-weighted;
* correlation: ``act(sum_c x1[corr1[c, v]] @ W_self[c] + sum_c
  x2[cross[f, c, v]] @ W_cross[c] + b)`` for each displacement f, in the
  direct (F, Cc) form, then the displacement MLP and filter;
* LeakyReLU(0.1) (``x >= 0 ? x : 0.1 x``).

Every product and sum is float32; autograd gives the gradients.  ``q``, when
given, rounds every operand of a product (features, weights, splat weights)
before it is used: the control's lower precision (:mod:`flowbench.control`).
``log``, when given, collects one entry per product for the work counter
(:mod:`flowbench.work`).
"""

from __future__ import annotations

import math

import torch

from .lattice import filter_size

__all__ = ["param_shapes", "init_params", "forward", "LEAKY", "NORM_EPS"]

LEAKY = 0.1
NORM_EPS = 1e-5


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _bcl_shapes(prefix, widths, taps, c_in, do_slice, use_bias):
    out = {f"{prefix}.conv0_kernel": (taps, c_in, widths[0]),
           f"{prefix}.conv0_bias": (widths[0],)}
    for i in range(1, len(widths)):
        out[f"{prefix}.conv{i}_kernel"] = (widths[i - 1], widths[i])
        out[f"{prefix}.conv{i}_bias"] = (widths[i],)
    if do_slice and use_bias:
        out[f"{prefix}.slice_bias"] = (widths[-1],)
    return out


def _mlp_shapes(prefix, widths, c_in):
    out, dims = {}, (c_in,) + tuple(widths)
    for i, w in enumerate(widths):
        out[f"{prefix}.dense{i}_kernel"] = (dims[i], w)
        out[f"{prefix}.dense{i}_bias"] = (w,)
    return out


def _corr_shapes(prefix, corr_widths, widths, corr_taps, filt_taps, c, prev):
    out = {f"{prefix}.corr0_kernel": (corr_taps, 2 * c + prev, corr_widths[0]),
           f"{prefix}.corr0_bias": (corr_widths[0],)}
    for i in range(1, len(corr_widths)):
        out[f"{prefix}.corr{i}_kernel"] = (corr_widths[i - 1], corr_widths[i])
        out[f"{prefix}.corr{i}_bias"] = (corr_widths[i],)
    out[f"{prefix}.blur0_kernel"] = (filt_taps, corr_widths[-1], widths[0])
    out[f"{prefix}.blur0_bias"] = (widths[0],)
    for i in range(1, len(widths)):
        out[f"{prefix}.blur{i}_kernel"] = (widths[i - 1], widths[i])
        out[f"{prefix}.blur{i}_bias"] = (widths[i],)
    return out


def _layout(cfg):
    """(encoder widths, decoder (width, C_in) per scale, corr widths, corr
    displacement widths, corr prev dims, refine MLP inputs or None)."""
    d1 = cfg["dim"] + 1
    if cfg["arch"] == "HPLFlowNet":
        dec = [(1024, d1 + 512 + 64), (512, d1 + 256 + 64),
               (256, d1 + 256 + 64 + 64), (256, d1 + 128 + 64 + 64),
               (128, d1 + 128 + 64 + 64), (128, d1 + 128 + 64 + 64),
               (128, 64 + 64)]
        return (64, 64), [((w, w), c) for w, c in dec], (32, 32), (64, 64), \
            (0, 64, 64, 64, 64), None, 1024
    if cfg["arch"] == "HPLFlowNetShallow":
        dec = [(128, d1 + 64 + 64), (64, d1 + 64 + 64),
               (64, d1 + 64 + 64 + 64), (64, d1 + 64 + 64 + 64), (64, 64 + 64)]
        return (64,), [((w,), c) for w, c in dec], (32,), (32,), (0, 64, 64), \
            (d1 + 32, d1 + 32, 32), 128
    raise ValueError(f"unknown arch {cfg['arch']!r}")


def param_shapes(cfg) -> dict:
    """Parameter name -> shape of the configuration's model."""
    d, sfm = cfg["dim"], cfg["scales_filter_map"]
    enc, dec, cw, ww, prevs, refine, head_in = _layout(cfg)
    d1 = d + 1
    use_bias = cfg["bcn_use_bias"]
    shapes = _mlp_shapes("conv1", (32, 32, 64), d)
    for i, row in enumerate(sfm):
        taps = filter_size(int(row[1]), d)
        shapes.update(_bcl_shapes(f"bcn{i + 1}", enc, taps, d1 + 64, False, use_bias))
        shapes.update(_bcl_shapes(f"bcn{i + 1}_", *dec[i][:1], taps, dec[i][1], True,
                           use_bias))
    for k, prev in enumerate(prevs):
        row = sfm[k + 2]
        shapes.update(_corr_shapes(f"corr{k + 1}", cw, ww, filter_size(int(row[3]), d),
                            filter_size(int(row[2]), d), 64, prev))
        if refine is not None:
            shapes.update(_mlp_shapes(f"corr{k + 1}_refine", (64, 64, 64), refine[k]))
    shapes.update(_mlp_shapes("conv2", (1024,), head_in))
    shapes.update(_mlp_shapes("conv3", (512,), 1024))
    shapes.update(_mlp_shapes("conv4", (3,), 512))
    return shapes


def init_params(cfg, seed: int, device) -> dict:
    """Seeded parameters, made on ``device`` in one draw: kernels
    Glorot-normal with the stencil axis counted into both fans, biases
    N(0, 0.01).  Names in sorted order take consecutive slices of the draw."""
    shapes = param_shapes(cfg)
    names = sorted(shapes)
    sizes = [math.prod(shapes[k]) for k in names]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    stds = []
    for k in names:
        shape = shapes[k]
        if k.endswith("kernel"):
            field = math.prod(shape[:-2]) if len(shape) > 2 else 1
            stds.append(math.sqrt(2.0 / ((shape[-2] + shape[-1]) * field)))
        else:
            stds.append(0.01)
    scale = torch.repeat_interleave(
        torch.tensor(stds, dtype=torch.float32, device=device),
        torch.tensor(sizes, device=device), output_size=sum(sizes))
    flat = flat * scale
    return {k: v.view(shapes[k]) for k, v in
            zip(names, torch.split(flat, sizes))}


# ---------------------------------------------------------------------------
# operations
# ---------------------------------------------------------------------------

class _Ctx:
    """What every operation of one forward shares: the rounding of product
    operands, the work log, the compute dtype's name."""

    def __init__(self, q, log):
        self.q = q if q is not None else (lambda x: x)
        self.log = log

    def record(self, **entry):
        if self.log is not None:
            self.log.append(entry)


def _act(x):
    return torch.where(x >= 0, x, LEAKY * x)


def _dense(ctx, x, w, b, rows):
    """``x @ w + b`` over (R, K) rows, ``rows`` of them real (the rest are
    a scale's padding)."""
    ctx.record(kind="dense", rows=rows, k=w.shape[0], n=w.shape[1])
    return ctx.q(x) @ ctx.q(w) + b


def _splat(ctx, feats, cloud, h, normalize=True):
    """(N, C) point features -> (H, C) vertex features."""
    c = feats.shape[1]
    f = ctx.q(feats)
    out = feats.new_zeros(h, c + 1)
    for r in range(cloud.offsets.shape[1]):
        ids = cloud.offsets[:, r]
        m = ids >= 0
        w = ctx.q(cloud.barycentric[:, r:r + 1])
        out = out.index_add(0, ids[m], torch.cat([f * w, w], dim=1)[m])
    ctx.record(kind="splat", entries=int((cloud.offsets >= 0).sum()), c=c,
               rows=cloud.num_valid)
    if not normalize:
        return out[:, :c]
    return out[:, :c] / (out[:, c:] + NORM_EPS)


def _spread(x, table):
    """(H_out, F, C) rows of ``x`` (H, C) at ``table`` (F, H_out), zero at -1."""
    pad = torch.cat([x.new_zeros(1, x.shape[1]), x])
    return pad[(table + 1).t()]


def _stencil(ctx, x, table, w, what, rows_in):
    """``sum_f x[table[f, v]] @ w[f]`` -> (H_out, C_out)."""
    f, c_in, c_out = w.shape
    ctx.record(kind="stencil", op=what, present=int((table >= 0).sum()),
               taps=f, c_in=c_in, c_out=c_out, rows_in=rows_in,
               rows_out=int((table >= 0).any(dim=0).sum()))
    sp = _spread(ctx.q(x), table)
    return sp.reshape(sp.shape[0], f * c_in) @ ctx.q(w).reshape(f * c_in, c_out)


def _slice(ctx, x, cloud):
    """(H, C) vertex features -> (N, C) at ``cloud``'s points."""
    xq = ctx.q(x)
    pad = torch.cat([xq.new_zeros(1, xq.shape[1]), xq])
    out = 0
    for r in range(cloud.offsets.shape[1]):
        ids = cloud.offsets[:, r]
        w = torch.where(ids >= 0, cloud.barycentric[:, r], 0.0)[:, None]
        out = out + ctx.q(w) * pad[ids + 1]
    ctx.record(kind="slice", entries=int((cloud.offsets >= 0).sum()),
               c=x.shape[1], rows=cloud.num_points)
    return out


def _bcl(ctx, p, prefix, feats, widths, blur_table, h, rows, splat_from=None,
         slice_to=None, norm=True):
    """Splat (from ``splat_from``'s points) or take vertex features, blur,
    pointwise convs, and slice onto ``slice_to``'s points."""
    x = _splat(ctx, feats, splat_from, h, norm) if splat_from is not None else feats
    x = _stencil(ctx, x, blur_table, p[f"{prefix}.conv0_kernel"], "blur", rows) \
        + p[f"{prefix}.conv0_bias"]
    if len(widths) > 1:
        x = _act(x)
    for i in range(1, len(widths)):
        x = _dense(ctx, x, p[f"{prefix}.conv{i}_kernel"],
                   p[f"{prefix}.conv{i}_bias"], rows)
        if i < len(widths) - 1:
            x = _act(x)
    if slice_to is None:
        return x
    x = _slice(ctx, x, slice_to)
    key = f"{prefix}.slice_bias"
    return x + p[key] if key in p else x


def _mlp_fwd(ctx, p, prefix, x, n_layers, rows, last_act=True):
    for i in range(n_layers):
        x = _dense(ctx, x, p[f"{prefix}.dense{i}_kernel"],
                   p[f"{prefix}.dense{i}_bias"], rows)
        if i < n_layers - 1 or last_act:
            x = _act(x)
    return x


def _correlation(ctx, p, prefix, cw, ww, f1, f2, prev, sc, norm=True):
    """The correlation BCL at one scale: (H1, C) and (H2, C) vertex
    features, the finer scale's correlation output (splatted onto cloud 1's
    vertices) or None -> (H1, ww[-1])."""
    c1 = sc.cloud1
    h1 = c1.coords.shape[0]
    rows = c1.num_valid
    k0 = p[f"{prefix}.corr0_kernel"]
    if prev is not None:
        combined = torch.cat([_splat(ctx, prev, c1, h1, norm), f1], dim=1)
    else:
        combined = f1
    self_dim = combined.shape[1]
    a_self = _stencil(ctx, combined, sc.corr1, k0[:, :self_dim], "corr_self",
                      rows) + p[f"{prefix}.corr0_bias"]
    nf, nc, _ = sc.cross.shape
    k_cross = k0[:, self_dim:]
    cross = torch.stack([
        _stencil(ctx, f2, sc.cross[f], k_cross, "corr_cross", sc.cloud2.num_valid)
        for f in range(nf)], dim=1)                          # (H1, F, W)
    y = _act(a_self[:, None, :] + cross)
    for i in range(1, len(cw)):
        y = _act(_dense(ctx, y.reshape(h1 * nf, -1), p[f"{prefix}.corr{i}_kernel"],
                        p[f"{prefix}.corr{i}_bias"], rows * nf).reshape(h1, nf, -1))
    w0 = p[f"{prefix}.blur0_kernel"]
    x = _dense(ctx, y.reshape(h1, -1), w0.reshape(-1, w0.shape[-1]),
               p[f"{prefix}.blur0_bias"], rows)
    if len(ww) > 1:
        x = _act(x)
    for i in range(1, len(ww)):
        x = _dense(ctx, x, p[f"{prefix}.blur{i}_kernel"], p[f"{prefix}.blur{i}_bias"],
                   rows)
        if i < len(ww) - 1:
            x = _act(x)
    return x


def forward(cfg, params: dict, pc1: torch.Tensor, pc2: torch.Tensor,
            scales: list, q=None, log: list | None = None) -> torch.Tensor:
    """(N, 3) float32 scene flow of ``pc1`` towards ``pc2``."""
    ctx = _Ctx(q, log)
    p = params
    enc, dec, cw, ww, prevs, refine, _ = _layout(cfg)
    norm = cfg["bcn_use_norm"]
    n_scales = len(scales)
    cat = lambda *xs: torch.cat(xs, dim=1)  # noqa: E731
    npts = scales[0].cloud1.num_points

    f1 = _mlp_fwd(ctx, p, "conv1", pc1.to(torch.float32), 3, npts)
    f2 = _mlp_fwd(ctx, p, "conv1", pc2.to(torch.float32), 3, npts)
    enc1, enc2 = [], []
    for s, sc in enumerate(scales):
        h1, h2 = sc.cloud1.coords.shape[0], sc.cloud2.coords.shape[0]
        f1 = _bcl(ctx, p, f"bcn{s + 1}", cat(sc.cloud1.el_minus_gr, f1), enc,
                  sc.blur1, h1, sc.cloud1.num_valid, splat_from=sc.cloud1, norm=norm)
        f2 = _bcl(ctx, p, f"bcn{s + 1}", cat(sc.cloud2.el_minus_gr, f2), enc,
                  sc.blur2, h2, sc.cloud2.num_valid, splat_from=sc.cloud2, norm=norm)
        enc1.append(f1)
        enc2.append(f2)
    corrs = {}
    prev = None
    for k in range(len(prevs)):
        s = k + 2
        c = _correlation(ctx, p, f"corr{k + 1}", cw, ww, enc1[s], enc2[s], prev,
                         scales[s], norm)
        if refine is not None:
            if s + 1 < n_scales:
                c = cat(scales[s + 1].cloud1.el_minus_gr, c)
            c = _mlp_fwd(ctx, p, f"corr{k + 1}_refine", c, 3,
                         scales[s].cloud1.num_valid)
        corrs[s] = c
        prev = c
    last = n_scales - 1
    out = None
    for s in range(last, -1, -1):
        sc = scales[s]
        if s == last:
            x = cat(corrs[s], enc1[s])
        else:
            parts = [scales[s + 1].cloud1.el_minus_gr, out]
            if s in corrs:
                parts.append(corrs[s])
            x = cat(*parts, enc1[s])
        out = _bcl(ctx, p, f"bcn{s + 1}_", x, dec[s][0], sc.blur1,
                   sc.cloud1.coords.shape[0], sc.cloud1.num_valid,
                   slice_to=sc.cloud1)
    rows = scales[0].cloud1.num_points
    out = _mlp_fwd(ctx, p, "conv2", out, 1, rows)
    out = _mlp_fwd(ctx, p, "conv3", out, 1, rows)
    return _mlp_fwd(ctx, p, "conv4", out, 1, rows, last_act=False)
