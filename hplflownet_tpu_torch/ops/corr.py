"""Correlation BCL: cross-cloud patch correlation on the lattice.

Port of ``hplflownet_tpu/ops/corr.py``, forward and hand-derived backward.
The first correlation conv is linear before its activation, so it splits
into a *self* term (the same for every displacement f) and a *cross* term:

    y[f] = act(spread1 @ W_self + spread2[f] @ W_cross + b)

The self term is one 15-tap stencil contraction (``corr_self``); the F x Cc
displaced patches of the cross term collapse onto U = 65 unique combined
offsets, with the static (f, c) -> u map folded into the kernel ``k2``, so
the cross term is one 65-tap stencil with an F * W wide output
(``corr_cross``).  Both run through the ``stencil_gather_matmul`` kernel.

Backward, scatter-free as in JAX:

* ``corr_self``: the input gradient is the same stencil over the negated-tap
  index table with the kernel transposed (``stencil_gather_matmul``), the
  weight gradient goes through ``stencil_dkernel``;
* ``corr_cross``: the tap-tables form of the JAX TPU path — one matmul
  ``z = g @ k2^T`` gives every tap's table, and ``stencil_tap_tables_sum``
  gathers them through the inverse map ``uniq_inv``; the weight gradient
  goes through ``stencil_dkernel`` over the 65 unique taps.

Each index table's stencil plan (``kernels.stencil_plan``), made once per
pair by the caller, gives the kernels their row order and tap lists.

Under ``ops.bcl.vertex_sharding`` the whole per-vertex chain (``corr_self``,
``corr_cross``, the correlation MLP and the displacement filter) runs on
this rank's columns of the H1 axis, and the output rows are all-gathered.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..kernels import backward_like_forward, plain_forced
from ..kernels.dkernel import stencil_dkernel
from ..kernels.stencil import stencil_gather_matmul
from ..kernels.stencil_plan import StencilPlan
from ..kernels.tap_tables import stencil_tap_tables_sum
from .bcl import (_negation_index, activation, dense, local_columns,
                  splat, vertex_shard)
from .shard import gather_parts
from .segment import ReducePlan, apply_reduce_plan

__all__ = ["gather_rows", "corr_self", "corr_cross", "fold_cross_kernel",
           "BilateralCorrelation"]


class _GatherRows(torch.autograd.Function):
    """``gather_rows`` of the JAX package (corr.py:46-68): the adjoint is a
    segment reduction of the cotangent through the plan, not a scatter."""

    @staticmethod
    def forward(ctx, table_pad, indices, plan):
        ctx.plain_kernels = plain_forced()
        ctx.plan = plan
        ctx.table_dtype = table_pad.dtype
        return table_pad[(indices + 1).long()]

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):
        if ctx.plan is None:
            raise ValueError("gather_rows' gradient needs the plan over its "
                             "indices")
        c = g.shape[-1]
        d_rows = apply_reduce_plan(ctx.plan, g.reshape(-1, c))   # (T, C)
        d_table = torch.cat([d_rows.new_zeros(1, c), d_rows])
        return d_table.to(ctx.table_dtype), None, None


def gather_rows(table_pad: torch.Tensor,        # (T + 1, C), row 0 zero
                indices: torch.Tensor,          # (...,) int32, -1 absent
                plan: ReducePlan | None = None  # over indices.reshape(-1)
                ) -> torch.Tensor:
    """``table_pad[indices + 1]``: row 0 is the zero row for absent ids.

    The gradient of ``table_pad`` reduces the cotangent through ``plan``
    (``segment.make_reduce_plan(indices, T)``) with ``apply_reduce_plan``;
    the forward does not read the plan.  The model does not call this op.
    """
    return _GatherRows.apply(table_pad, indices, plan)


class _CorrSelf(torch.autograd.Function):
    """``corr_self`` of the JAX package (corr.py:71-129)."""

    @staticmethod
    def forward(ctx, table_pad, indices, k_self, bias, tap_negation, plan):
        ctx.plain_kernels = plain_forced()
        ctx.tap_negation = tap_negation
        ctx.plan = plan
        ctx.save_for_backward(table_pad, indices, k_self)
        return stencil_gather_matmul(table_pad[1:].contiguous(),
                                     indices.contiguous(),
                                     k_self.contiguous(), bias=bias,
                                     plan=plan)

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):                                   # g: (H1, W)
        table_pad, indices, k_self = ctx.saved_tensors
        dt = table_pad.dtype
        gc = g.to(dt).contiguous()
        d_table = d_k = d_bias = None
        if ctx.needs_input_grad[0]:
            if ctx.tap_negation is None:
                raise ValueError("corr_self's input gradient needs tap_negation")
            neg = _negation_index(ctx.tap_negation, indices.device)
            d_rows = stencil_gather_matmul(
                gc, indices[neg].contiguous(),
                k_self.transpose(1, 2).contiguous().to(dt), out_dtype=dt,
                plan=ctx.plan)
            d_table = torch.cat([d_rows.new_zeros(1, d_rows.shape[1]), d_rows])
        if ctx.needs_input_grad[2]:
            d_k = stencil_dkernel(table_pad[1:].contiguous(),
                                  indices.contiguous(), gc,
                                  ctx.plan).to(k_self.dtype)
        if ctx.needs_input_grad[3]:
            d_bias = g.to(torch.float32).sum(dim=0)
        return d_table, None, d_k, d_bias, None, None


def corr_self(table_pad: torch.Tensor,   # (H1 + 1, C), row 0 zero
              indices: torch.Tensor,     # (Cc, H1) int32, -1 absent
              k_self: torch.Tensor,      # (Cc, C, W)
              bias: torch.Tensor,        # (W,) f32, fused into the epilogue
              tap_negation: Sequence[int] | None = None,
              plan: StencilPlan | None = None,   # of indices over H1 rows
              ) -> torch.Tensor:
    """sum_k table_pad[indices[k] + 1] @ k_self[k] + bias -> (H1, W) f32.

    ``tap_negation`` (of the correlation stencil) is what the input gradient
    needs; the forward does not read it.
    """
    return _CorrSelf.apply(table_pad, indices, k_self, bias, tap_negation,
                           plan)


class _CorrCross(torch.autograd.Function):
    """``corr_cross`` of the JAX package (corr.py:136-234), tap-tables
    adjoint."""

    @staticmethod
    def forward(ctx, pad2, uniq_idx, k2, uniq_inv, plan):
        ctx.plain_kernels = plain_forced()
        u, c, f, w = k2.shape
        ctx.uniq_inv = uniq_inv
        ctx.plan = plan
        ctx.save_for_backward(pad2, uniq_idx, k2)
        flat = stencil_gather_matmul(pad2[1:].contiguous(),
                                     uniq_idx.contiguous(),
                                     k2.reshape(u, c, f * w).contiguous(),
                                     plan=plan)
        return flat.reshape(flat.shape[0], f, w)

    @staticmethod
    @backward_like_forward
    def backward(ctx, g):                                   # g: (H1, F, W)
        pad2, uniq_idx, k2 = ctx.saved_tensors
        u, c, f, w = k2.shape
        dt = pad2.dtype
        f32 = torch.float32
        g_flat = g.to(dt).reshape(g.shape[0], f * w).contiguous()
        d_pad2 = d_k2 = None
        if ctx.needs_input_grad[0]:
            if ctx.uniq_inv is None:
                raise ValueError("corr_cross's input gradient needs uniq_inv")
            # z[:, u*C:(u+1)*C] = g @ k2[u]^T, every tap's table in one
            # product, rounded to the compute dtype as in JAX
            k2m = k2.reshape(u, c, f * w).permute(2, 0, 1).reshape(f * w, u * c)
            z = (g_flat.to(f32) @ k2m.to(f32)).to(dt)
            d_rows = stencil_tap_tables_sum(z, c, ctx.uniq_inv.contiguous())
            d_pad2 = torch.cat([d_rows.new_zeros(1, c), d_rows]).to(dt)
        if ctx.needs_input_grad[2]:
            d_k2 = stencil_dkernel(pad2[1:].contiguous(), uniq_idx.contiguous(),
                                   g_flat, ctx.plan).reshape(u, c, f, w).to(k2.dtype)
        return d_pad2, None, d_k2, None, None


def corr_cross(pad2: torch.Tensor,       # (H2 + 1, C)
               uniq_idx: torch.Tensor,   # (U, H1) unique-offset index rows
               k2: torch.Tensor,         # (U, C, F, W) folded kernel
               uniq_inv: torch.Tensor | None = None,  # (U, H2) adjoint map
               plan: StencilPlan | None = None,  # of uniq_idx over H2 rows
               ) -> torch.Tensor:
    """cross[h, f, w] = sum_u pad2[uniq_idx[u, h] + 1] @ k2[u] -> (H1, F, W).

    ``uniq_inv`` (the lattice build's ``pc2_corr_uniq_inv``) is what the
    gradient of ``pad2`` needs; the forward does not read it.
    """
    return _CorrCross.apply(pad2, uniq_idx, k2, uniq_inv, plan)


def fold_cross_kernel(k_cross: torch.Tensor,   # (Cc, C, W)
                      inverse: torch.Tensor,   # (F, Cc) int32 -> u
                      n_uniq: int, dt: torch.dtype) -> torch.Tensor:
    """k2[u, :, f] = sum_{c : inverse[f, c] == u} k_cross[c] -> (U, C, F, W).

    For one f the combined offsets are distinct, so each (u, f) takes at
    most one term: the fold is an exact selection.  ``k_cross`` is rounded
    to ``dt`` first, as in JAX, so its gradient is rounded there too.
    """
    uid = torch.arange(n_uniq, dtype=inverse.dtype, device=inverse.device)
    onehot = (inverse[..., None] == uid).to(torch.float32)    # (F, Cc, U)
    return torch.einsum("fku,kcw->ucfw", onehot,
                        k_cross.to(dt).to(torch.float32)).to(dt)


class BilateralCorrelation(nn.Module):
    """Patch correlation (``corr_widths``) + displacement filtering (``widths``).

    Parameter names and layouts match the flax module: ``corr0_kernel``
    ``(corr_size, self_dim + num_input, corr_widths[0])`` with input
    channels ordered [prev, feat1 | feat2], ``blur0_kernel``
    ``(filter_size, corr_widths[-1], widths[0])``, the rest pointwise.
    ``corr_tap_negation`` (the correlation stencil's negation permutation)
    and the forward's ``pc2_corr_uniq_inv`` are needed for gradients only.
    """

    def __init__(self, corr_widths: Sequence[int], widths: Sequence[int],
                 corr_size: int, filter_size: int, num_input: int,
                 prev_corr_dim: int = 0, use_norm: bool = True,
                 use_leaky: bool = True, last_relu: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 corr_tap_negation: Sequence[int] | None = None, device=None):
        super().__init__()
        self.corr_tap_negation = (tuple(corr_tap_negation)
                                  if corr_tap_negation is not None else None)
        self.corr_widths = tuple(corr_widths)
        self.widths = tuple(widths)
        self.prev_corr_dim = prev_corr_dim
        self.use_norm = use_norm
        self.use_leaky = use_leaky
        self.last_relu = last_relu
        self.compute_dtype = compute_dtype
        self.self_dim = num_input + prev_corr_dim

        def p(*shape):
            return nn.Parameter(torch.zeros(shape, device=device))

        cw, w = self.corr_widths, self.widths
        self.corr0_kernel = p(corr_size, self.self_dim + num_input, cw[0])
        self.corr0_bias = p(cw[0])
        for i in range(1, len(cw)):
            setattr(self, f"corr{i}_kernel", p(cw[i - 1], cw[i]))
            setattr(self, f"corr{i}_bias", p(cw[i]))
        self.blur0_kernel = p(filter_size, cw[-1], w[0])
        self.blur0_bias = p(w[0])
        for i in range(1, len(w)):
            setattr(self, f"blur{i}_kernel", p(w[i - 1], w[i]))
            setattr(self, f"blur{i}_bias", p(w[i]))

    def forward(self, feat1: torch.Tensor,        # (H1, C)
                feat2: torch.Tensor,              # (H2, C)
                prev_corr_feat,                   # (N_in, prev) or None
                barycentric1, splat_plan1: ReducePlan | None,
                pc1_corr_indices: torch.Tensor,   # (Cc, H1)
                pc2_corr_uniq: torch.Tensor,      # (U, H1)
                pc2_corr_inverse: torch.Tensor,   # (F, Cc) -> u
                pc2_corr_uniq_inv: torch.Tensor | None = None,  # (U, H2)
                self_plan: StencilPlan | None = None,   # of pc1_corr_indices
                cross_plan: StencilPlan | None = None,  # of pc2_corr_uniq
                ) -> torch.Tensor:
        dt = self.compute_dtype
        f32 = torch.float32
        c = feat1.shape[-1]
        # under ops.bcl.vertex_sharding the per-vertex chain runs on this
        # rank's H1 columns (the plans are the columns'), gathered at the end
        shard = vertex_shard()
        h1_all = pc1_corr_indices.shape[1]
        pc1_corr_indices = local_columns(pc1_corr_indices)
        pc2_corr_uniq = local_columns(pc2_corr_uniq)
        pad1 = torch.cat([feat1.new_zeros(1, c), feat1])
        if self.prev_corr_dim:
            # splat the finer scale's correlation output onto this scale's
            # cloud-1 lattice
            prev_pad = splat(prev_corr_feat.to(dt), barycentric1, splat_plan1,
                             normalize=self.use_norm)
            combined1 = torch.cat([prev_pad.to(f32), pad1.to(f32)], dim=-1)
        else:
            combined1 = pad1
        pad2 = torch.cat([feat2.new_zeros(1, c), feat2])
        combined1 = combined1.to(dt)
        pad2 = pad2.to(dt)

        # ---- patch-correlation stage ----
        k_self = self.corr0_kernel[:, :self.self_dim, :].to(dt)
        k_cross = self.corr0_kernel[:, self.self_dim:, :]
        a_self = corr_self(combined1, pc1_corr_indices, k_self,
                           self.corr0_bias, self.corr_tap_negation, self_plan)
        k2 = fold_cross_kernel(k_cross, pc2_corr_inverse,
                               pc2_corr_uniq.shape[0], dt)
        cross = corr_cross(pad2, pc2_corr_uniq, k2, pc2_corr_uniq_inv,
                           cross_plan)
        y = activation(a_self[:, None, :] + cross, self.use_leaky)  # (H1, F, W)

        h1, nf, _ = y.shape
        for i in range(1, len(self.corr_widths)):
            k = getattr(self, f"corr{i}_kernel")
            y = dense(y.reshape(h1 * nf, -1), k, dt).reshape(h1, nf, -1)
            y = activation(y + getattr(self, f"corr{i}_bias"), self.use_leaky)

        # ---- displacement-filtering stage ----
        x = (dense(y.reshape(h1, -1), self.blur0_kernel.reshape(
            -1, self.widths[0]), dt) + self.blur0_bias)
        if len(self.widths) > 1 or self.last_relu:
            x = activation(x, self.use_leaky)
        x = x.to(dt)
        for i in range(1, len(self.widths)):
            x = dense(x, getattr(self, f"blur{i}_kernel"), dt) + getattr(
                self, f"blur{i}_bias")
            if i < len(self.widths) - 1 or self.last_relu:
                x = activation(x, self.use_leaky)
            x = x.to(dt)
        return x if shard is None else gather_parts(x, h1_all, shard)
