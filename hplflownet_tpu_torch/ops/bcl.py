"""Bilateral Convolution Layer (BCL): splat -> blur -> slice.

Port of ``hplflownet_tpu/ops/bcl.py``, forward and hand-derived backward.
Like the JAX layer it is scatter-free in both directions: every gather of a
differentiable tensor sits inside an autograd Function whose backward is a
gather or a deterministic kernel, never ``index_add_`` / ``scatter_add_``.

* ``splat``: barycentric-weighted reduction of point features onto lattice
  vertices through the lattice build's splat plan, normalised by
  ``1 / (density + 1e-5)``; the run sums go through the ``rank_reduce``
  kernel on CUDA, the adjoint is a gather (``segment.weighted_reduce``).
* ``blur``: the multi-tap stencil conv through the
  ``stencil_gather_matmul`` kernel, with the bias, activation and output
  cast fused into its epilogue.  Its input gradient is the same kernel over
  the negated-tap table with the kernel transposed (the stencil is closed
  under negation); its weight gradient goes through ``stencil_dkernel``.
  The table's stencil plan (``kernels.stencil_plan``), made once per pair
  by the caller, gives both kernels their row order and tap lists; the
  input gradient reuses the forward's row order.
* ``slice_to_points``: each point's d+1 vertices, barycentric-weighted;
  absent vertices (id -1) get weight zero.  One ``slice_points`` launch
  with the BCL's slice bias and output cast fused; its adjoint is an
  unnormalised splat of the cotangent through the same plan
  (``rank_reduce``).
* ``dense``: a dense layer (the BCL's pointwise convs, the point MLPs, the
  correlation's MLP and displacement filter): one ``dense_gemm`` launch with
  the bias, activation and output cast in its epilogue; its backward is the
  float32 one autograd formed for the composition it replaces.
* ``BilateralConv``: the module, with the flax parameter names and layouts
  (``conv0_kernel`` is ``(F, C_in, C_out)``).
* ``vertex_sharding``: within it, ``blur`` (and the correlation BCL,
  ``ops/corr.py``) computes only this rank's part of the output vertices
  and all-gathers the rest over a mesh axis; splat, slice and the
  point-wise layers stay replicated (JAX: GSPMD's partition of the
  vertex-constrained blur and correlation outputs).  Forward only.

Single-sample, channels-last.  Vertex id -1 is absent; every vertex table
passed between layers carries a zero row 0 (ids shifted by +1).
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..device import device_constant, scalar
from ..kernels import backward_like_forward, plain_forced
from ..kernels.dense import dense_gemm, gemm_weight, uses_kernel
from ..kernels.dkernel import stencil_dkernel
from ..kernels.slice import slice_points
from ..kernels.stencil import stencil_gather_matmul
from ..kernels.stencil_plan import StencilPlan
from ..utils.profiling import span
from .segment import ReducePlan, _wr_forward, weighted_reduce
from .shard import axis_shard, gather_parts, local_part

__all__ = ["splat", "blur", "slice_to_points", "BilateralConv",
           "LEAKY_RATE", "NORM_EPS", "activation", "slope_of", "dense",
           "vertex_sharding", "vertex_shard", "local_columns"]

# Call-time hook for splitting the vertex axis over a mesh axis (see
# parallel/lattice_parallel.py): the AxisShard of this rank, or None.
_VERTEX_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "vertex_shard", default=None)


@contextlib.contextmanager
def vertex_sharding(mesh, axis: str = "lattice"):
    """Split the output vertices of every blur and correlation BCL called
    in the block over ``mesh``'s ``axis`` (a ``parallel.Mesh``): each rank
    computes ``ceil(H / R)`` rows of an H-row output, the table padded with
    absent (-1) columns, and an all-gather assembles them.  Every rank of
    the axis must run the same forward, without gradients.  Without a
    process group, or with one rank on the axis, nothing is split."""
    token = _VERTEX_SHARD.set(axis_shard(mesh, axis))
    try:
        yield
    finally:
        _VERTEX_SHARD.reset(token)


def vertex_shard():
    """The active vertex split (an ``ops.shard.AxisShard``), or None."""
    shard = _VERTEX_SHARD.get()
    if shard is not None and torch.is_grad_enabled():
        raise RuntimeError("vertex sharding is forward only: run the model "
                           "under torch.inference_mode()")
    return shard


def local_columns(table: torch.Tensor) -> torch.Tensor:
    """This rank's columns of an index table (F, H) under
    :func:`vertex_sharding` (padded with -1 columns), else the table: the
    columns a sharded op computes, and what its stencil plan is made of."""
    shard = _VERTEX_SHARD.get()
    return table if shard is None else local_part(table, 1, -1, shard)

LEAKY_RATE = 0.1
NORM_EPS = 1e-5


def activation(x: torch.Tensor, use_leaky: bool) -> torch.Tensor:
    """LeakyReLU(0.1) (``x >= 0 ? x : 0.1 x``) or ReLU, as jax.nn does it.

    The gradients at exactly 0 are jax.nn's too: 1 for the leaky rule, 0 for
    ReLU (``torch.clamp_min`` would give 1 there).
    """
    if use_leaky:
        return torch.where(x >= 0, x, LEAKY_RATE * x)
    return torch.where(x > 0, x, 0.0)


def splat(features: torch.Tensor,     # (N, C)
          barycentric: torch.Tensor,  # (N, d1)
          plan: ReducePlan,
          normalize: bool = True) -> torch.Tensor:
    """(H + 1, C) float32 vertex features; row 0 is the zero sentinel row."""
    c = features.shape[-1]
    out = weighted_reduce(normalize, plan, features, barycentric)  # (H, C[+1])
    if normalize:
        out = out[:, :c] * (1.0 / (out[:, c] + NORM_EPS))[:, None]
    return torch.cat([out.new_zeros(1, c), out], dim=0)


def _negation_index(tap_negation, device) -> torch.Tensor:
    return device_constant(np.asarray(tap_negation, dtype=np.int64), device)


def _act_grad(act_slope, y: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Cotangent through the activation, from its saved OUTPUT.

    The activations are monotone: ReLU passes where y > 0 (gradient 0 at 0,
    as jax.nn.relu); leaky passes where y >= 0, else slope * g in g's dtype
    (gradient 1 at 0, as jax.nn.leaky_relu).
    """
    if act_slope is None:
        return g
    if act_slope == 0.0:
        return torch.where(y > 0, g, 0.0)
    return torch.where(y >= 0, g, scalar(act_slope, g.device, g.dtype) * g)


def slope_of(use_leaky: bool) -> float:
    """The ``act_slope`` of :func:`activation`'s rule: the leaky slope, or 0
    for ReLU."""
    return LEAKY_RATE if use_leaky else 0.0


class _Dense(torch.autograd.Function):
    """A dense layer through ``dense_gemm`` (the JAX package's ``jnp.dot``
    with ``preferred_element_type=float32``, then bias, activation and cast).

    The backward is the mixed-precision one autograd formed for the
    composition: float32 products of the float32 cotangent with the
    operands rounded to ``dt``, the input and weight gradients rounded to
    ``dt`` (and back to the input's and weight's dtypes), the bias gradient
    summed in float32.  On the card the weight's rounded copy is the one the
    forward's kernel read, kept.
    """

    @staticmethod
    def forward(ctx, x, kernel, bias, act_slope, out_dtype, dt):
        # the kernel's transposed, rounded weight, kept for the backward
        wt = gemm_weight(kernel, dt) if uses_kernel(x) else None
        y = dense_gemm(x, kernel, bias, act_slope, out_dtype, dt, wt=wt)
        ctx.act_slope = act_slope
        ctx.dt = dt
        ctx.has_bias = bias is not None
        ctx.kept_wt, ctx.kernel_dtype = wt is not None, kernel.dtype
        ctx.save_for_backward(x, kernel if wt is None else wt, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, w, y = ctx.saved_tensors
        f32, dt = torch.float32, ctx.dt
        gp = _act_grad(ctx.act_slope, y, g.to(f32))
        d_x = d_kernel = d_bias = None
        if ctx.needs_input_grad[0]:
            # the weight rounded to dt, (K, N) in float32: from the kept
            # W^T (its zero channels past K dropped) in one copy, or made
            # here; the product sees the layout the composition gave it
            w32 = (w[:, :x.shape[1]].t().to(
                f32, memory_format=torch.contiguous_format) if ctx.kept_wt
                else w.to(dt).to(f32))
            d_x = gp.mm(w32.t()).to(dt).to(x.dtype)
        if ctx.needs_input_grad[1]:
            d_kernel = x.to(dt).to(f32).t().mm(gp).to(dt).to(ctx.kernel_dtype)
        if ctx.has_bias and ctx.needs_input_grad[2]:
            d_bias = gp.sum(dim=0)
        return d_x, d_kernel, d_bias, None, None, None


def dense(x: torch.Tensor,             # (M, K)
          kernel: torch.Tensor,        # (K, N)
          bias: torch.Tensor | None,   # (N,) f32
          act_slope: float | None,
          out_dtype: torch.dtype,
          dt: torch.dtype) -> torch.Tensor:
    """act(x @ kernel + bias) -> (M, N) in ``out_dtype``, both operands
    rounded to ``dt``.

    The products of bf16 values are exact in float32 and sum in float32
    ("bf16 inputs, float32 accumulation"); the bias, the activation
    (``act_slope`` as :func:`blur`'s: None linear, 0.0 ReLU, else leaky)
    and the cast run in float32 on the result, in one kernel on the card
    (``kernels.dense``).
    """
    return _Dense.apply(x, kernel, bias, act_slope, out_dtype, dt)


class _Blur(torch.autograd.Function):
    """``blur_matmul`` of the JAX package (bcl.py:111-283)."""

    @staticmethod
    def forward(ctx, splatted_pad, neighbors, kernel, bias, act_slope,
                out_dtype, tap_negation, plan):
        ctx.plain_kernels = plain_forced()
        y = stencil_gather_matmul(splatted_pad[1:].contiguous(),
                                  neighbors.contiguous(), kernel.contiguous(),
                                  bias=bias, act_slope=act_slope,
                                  out_dtype=out_dtype, plan=plan)
        ctx.plan = plan
        ctx.act_slope = act_slope
        ctx.tap_negation = tap_negation
        ctx.has_bias = bias is not None
        ctx.save_for_backward(splatted_pad, neighbors, kernel, y)
        return y

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):
        splatted_pad, neighbors, kernel, y = ctx.saved_tensors
        dt = splatted_pad.dtype
        gp = _act_grad(ctx.act_slope, y, g)
        gc = gp.to(dt).contiguous()       # mixed-precision backward, as JAX
        d_pad = d_kernel = d_bias = None
        if ctx.needs_input_grad[0]:
            if ctx.tap_negation is None:
                raise ValueError("blur's input gradient needs tap_negation")
            neg = _negation_index(ctx.tap_negation, neighbors.device)
            # whoever reads vertex v through tap f is v's neighbour through
            # the negated tap: the transpose is the same stencil
            d_sp = stencil_gather_matmul(
                gc, neighbors[neg].contiguous(),
                kernel.transpose(1, 2).contiguous(), out_dtype=dt,
                plan=ctx.plan)
            d_pad = torch.cat([d_sp.new_zeros(1, d_sp.shape[1]), d_sp])
        if ctx.needs_input_grad[2]:
            d_kernel = stencil_dkernel(splatted_pad[1:].contiguous(),
                                       neighbors.contiguous(), gc, ctx.plan
                                       ).to(kernel.dtype)
        if ctx.has_bias and ctx.needs_input_grad[3]:
            d_bias = gp.to(torch.float32).sum(dim=0)
        return d_pad, None, d_kernel, d_bias, None, None, None, None


def blur(splatted_pad: torch.Tensor,   # (H + 1, C_in), row 0 zero
         neighbors: torch.Tensor,      # (F, H) int32, -1 absent
         kernel: torch.Tensor,         # (F, C_in, C_out)
         bias: torch.Tensor | None,    # (C_out,) f32
         act_slope: float | None,
         out_dtype: torch.dtype,
         tap_negation: Sequence[int] | None = None,
         plan: StencilPlan | None = None) -> torch.Tensor:
    """act(stencil conv + bias) over the lattice -> (H, C_out).

    ``tap_negation`` (lattice.offsets.tap_negation of the stencil) is what
    the input gradient needs; the forward does not read it.  ``plan`` is
    the stencil plan of ``neighbors`` over H rows (made by the kernels from
    the table when it is None); under :func:`vertex_sharding`, the plan of
    the rank's columns (:func:`local_columns`).
    """
    shard = vertex_shard()
    if shard is None:
        return _Blur.apply(splatted_pad, neighbors, kernel, bias, act_slope,
                           out_dtype, tap_negation, plan)
    y = _Blur.apply(splatted_pad, local_columns(neighbors), kernel, bias,
                    act_slope, out_dtype, tap_negation, plan)
    return gather_parts(y, neighbors.shape[1], shard)


class _Slice(torch.autograd.Function):
    """``slice_to_points`` of the JAX package (bcl.py:290-337), with the
    BCL's slice bias and output cast, through ``slice_points``.

    The backward gives what autograd formed for the composition it
    replaces (the float32 slice, ``+ bias``, ``.to(out_dtype)``): the
    cotangent in float32; the bias gradient its float32 sum over points.
    """

    @staticmethod
    def forward(ctx, blurred, out_barycentric, out_lattice_offset, plan, bias,
                out_dtype):
        ctx.plain_kernels = plain_forced()
        ctx.plan = plan
        ctx.has_bias = bias is not None
        ctx.blurred_dtype = blurred.dtype
        # the weights' gradient alone reads the table and the ids
        ctx.save_for_backward(out_barycentric, *(
            (blurred, out_lattice_offset) if ctx.needs_input_grad[1] else ()))
        return slice_points(blurred.contiguous(), out_barycentric.contiguous(),
                            out_lattice_offset.contiguous(), bias, out_dtype)

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):
        bary, *table_and_ids = ctx.saved_tensors
        g32 = g.to(torch.float32)
        d_blurred = d_bary = d_bias = None
        if ctx.needs_input_grad[0]:
            if ctx.plan is None:
                raise ValueError("slice's gradient needs the scale's splat plan")
            # the unnormalised splat of the cotangent through the same plan
            dt = ctx.blurred_dtype
            d_blurred = _wr_forward(False, ctx.plan, g.to(dt), bary).to(dt)
        if ctx.needs_input_grad[1]:
            blurred, offsets = table_and_ids
            h = blurred.shape[0]
            d_bary = torch.stack(
                [torch.sum(g32 * blurred[offsets[:, r].clamp(0, h - 1).long()],
                           dim=1) for r in range(offsets.shape[1])], dim=1)
            d_bary = torch.where(offsets >= 0, d_bary, 0.0)
        if ctx.has_bias and ctx.needs_input_grad[4]:
            d_bias = g32.sum(dim=0)
        return d_blurred, d_bary, None, None, d_bias, None


def slice_to_points(blurred: torch.Tensor,             # (H, C)
                    out_barycentric: torch.Tensor,     # (N, d1) f32
                    out_lattice_offset: torch.Tensor,  # (N, d1) int32
                    plan: ReducePlan | None = None,    # the scale's splat plan
                    bias: torch.Tensor | None = None,  # (C,) f32
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Barycentric combination of each point's d+1 vertices, plus ``bias``
    -> (N, C) in ``out_dtype`` (float32 sums, then the cast).

    Id -1 marks an absent vertex: an invalid point (zero weight already) or
    a valid point whose vertex overflowed capacity (nonzero weight) — a
    clamp would alias the latter onto row 0, a real vertex, so its weight
    is zeroed.  ``plan`` (the splat plan of the same cloud and scale) is
    what the gradient of ``blurred`` needs.
    """
    return _Slice.apply(blurred, out_barycentric, out_lattice_offset, plan,
                        bias, out_dtype)


class BilateralConv(nn.Module):
    """BCL with an optional splat front-end and slice back-end.

    ``widths``: conv widths; the first conv contracts the stencil axis
    (``conv0_kernel`` of shape ``(filter_size, num_input, widths[0])``),
    the rest are pointwise (``conv{i}_kernel`` of shape ``(in, out)``).
    Parameter names match the flax module one for one.  ``tap_negation``
    (the stencil's negation permutation) is needed for gradients only.
    Inside ``utils.profiling.tracing()`` the forward marks ``model.splat``,
    ``model.blur`` (the stencil conv) and ``model.slice``.
    """

    def __init__(self, widths: Sequence[int], filter_size: int,
                 num_input: int, do_splat: bool, do_slice: bool,
                 use_norm: bool = True, use_bias: bool = True,
                 use_leaky: bool = True, last_relu: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 tap_negation: Sequence[int] | None = None, device=None):
        super().__init__()
        self.widths = tuple(widths)
        self.tap_negation = (tuple(tap_negation) if tap_negation is not None
                             else None)
        self.do_splat = do_splat
        self.do_slice = do_slice
        self.use_norm = use_norm
        self.use_bias = use_bias
        self.use_leaky = use_leaky
        self.last_relu = last_relu
        self.compute_dtype = compute_dtype

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        self.conv0_kernel = p(filter_size, num_input, self.widths[0])
        self.conv0_bias = p(self.widths[0])
        for i in range(1, len(self.widths)):
            setattr(self, f"conv{i}_kernel", p(self.widths[i - 1], self.widths[i]))
            setattr(self, f"conv{i}_bias", p(self.widths[i]))
        if do_slice and use_bias:
            self.slice_bias = p(self.widths[-1])

    def forward(self, features: torch.Tensor,  # (N_in, C) if splat else (H, C)
                in_barycentric=None, splat_plan: ReducePlan | None = None,
                blur_neighbors=None, out_barycentric=None,
                out_lattice_offset=None,
                out_splat_plan: ReducePlan | None = None,
                blur_plan: StencilPlan | None = None) -> torch.Tensor:
        dt = self.compute_dtype
        c = features.shape[-1]
        if self.do_splat:
            with span("model.splat"):
                # cast before the splat: a bf16 stream moves half the bytes
                splatted_pad = splat(features.to(dt), in_barycentric,
                                     splat_plan, normalize=self.use_norm).to(dt)
        else:
            splatted_pad = torch.cat([features.new_zeros(1, c), features]).to(dt)

        if len(self.widths) > 1 or self.last_relu:
            slope = slope_of(self.use_leaky)
        else:
            slope = None
        with span("model.blur"):
            x = blur(splatted_pad, blur_neighbors, self.conv0_kernel.to(dt),
                     self.conv0_bias, slope, dt, self.tap_negation, blur_plan)

        for i in range(1, len(self.widths)):
            on = i < len(self.widths) - 1 or self.last_relu
            x = dense(x, getattr(self, f"conv{i}_kernel"),
                      getattr(self, f"conv{i}_bias"),
                      slope_of(self.use_leaky) if on else None, dt, dt)

        if not self.do_slice:
            return x
        with span("model.slice"):
            return slice_to_points(x, out_barycentric, out_lattice_offset,
                                   out_splat_plan,
                                   self.slice_bias if self.use_bias else None,
                                   dt)
