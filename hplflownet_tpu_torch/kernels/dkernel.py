"""``stencil_dkernel``: the weight gradient of the stencil contraction.

    dW[f] = sum_v table[nb[f, v]]^T (x) g[v]                -> (F, C_in, C_out)

Replaces ``hplflownet_tpu/ops/pallas_stencil.py`` ``stencil_dkernel``
(:340; ``pallas_call`` :406, body ``_dk_kernel`` :304).  On CUDA tensors the
wrapper launches ``csrc/stencil_dkernel.cu``; on CPU tensors it runs
:func:`stencil_dkernel_plain`.  The kernel sums each tap over the stencil
plan's compacted list of present vertices (``kernels.stencil_plan``), which
the caller passes as ``plan`` (made from the table when it is None).  The
kernel source states its bound on the card and what its design does about
it.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry
from .stencil_plan import StencilPlan, make_stencil_plan

__all__ = ["stencil_dkernel", "stencil_dkernel_plain", "vertex_splits"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_STAGE = 64           # list entries per stage
_TARGET_BLOCKS = 264  # two waves of one block on each of the H100's 132 SMs
_MIN_CHUNK = 4        # stages per chunk, at least


def stencil_dkernel_plain(table, neighbors, g):
    """Plain PyTorch version: contract the materialised (F, H_out, C_in)
    spread with the cotangent, in float32 (exact products for bf16)."""
    c_in = table.shape[1]
    pad = torch.cat([table.new_zeros(1, c_in), table]).to(torch.float32)
    spread = pad[(neighbors + 1).long()]                    # (F, H_out, C_in)
    return torch.einsum("fhi,ho->fio", spread, g.to(torch.float32))


def _tile(c_in: int, c_out: int):
    """The bf16 kernel's output tile (C_in rows, C_out columns), as
    ``launch_bf16`` in csrc/stencil_dkernel.cu picks it."""
    if c_in <= 64 and c_out > 128:
        return 64, 256
    return 128, (64 if c_out <= 64 else 128)


def vertex_splits(num_taps: int, c_in: int, c_out: int, h_out: int):
    """(splits, chunk): how the kernel cuts each tap's vertex list.

    A function of the shapes alone, so a rerun sums in the same order.
    Output tiles too few to fill the card get more chunks, each of at least
    ``_MIN_CHUNK`` stages.  The grid is sized for a list of ``h_out``
    entries, which only an occupied centre tap nears: the blocks of chunks
    past a tap's count exit at once, so the longest list (the centre tap's)
    runs in the most chunks and no block sums more than ``chunk`` entries.
    """
    tile_in, tile_out = _tile(c_in, c_out)
    tiles = (-(-c_in // tile_in)) * (-(-c_out // tile_out)) * num_taps
    stages = max(1, -(-h_out // _STAGE))
    splits = max(1, min(-(-_TARGET_BLOCKS // tiles), stages // _MIN_CHUNK))
    chunk = -(-stages // splits) * _STAGE
    return max(1, -(-h_out // chunk)), chunk


def _check_args(table, neighbors, g):
    if table.dtype not in _DTYPES or g.dtype != table.dtype:
        raise TypeError(f"table and g must share float32 or bfloat16, got "
                        f"{table.dtype} and {g.dtype}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be int32, got {neighbors.dtype}")
    if table.dim() != 2 or neighbors.dim() != 2 or g.dim() != 2:
        raise ValueError("expected table (H, C_in), neighbors (F, H_out), "
                         "g (H_out, C_out)")
    if g.shape[0] != neighbors.shape[1]:
        raise ValueError(f"shape mismatch: neighbors {tuple(neighbors.shape)}, "
                         f"g {tuple(g.shape)}")
    for t in (table, neighbors, g):
        if t.device != table.device:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def _check_plan(plan: StencilPlan, neighbors):
    f, h_out = neighbors.shape
    for name, t, shape in (("verts", plan.verts, (f, h_out)),
                           ("rows", plan.rows, (f, h_out)),
                           ("counts", plan.counts, (f,))):
        if t.dtype != torch.int32 or tuple(t.shape) != shape:
            raise ValueError(f"plan.{name} must be int32 of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != neighbors.device or t.stride(-1) != 1:
            raise ValueError(f"plan.{name} must be on {neighbors.device}, "
                             f"contiguous along its last axis")
    if plan.rows.stride() != plan.verts.stride():
        raise ValueError("plan.rows and plan.verts must share their strides")


def stencil_dkernel(table: torch.Tensor,      # (H, C_in), no sentinel row
                    neighbors: torch.Tensor,  # (F, H_out) int32, -1 absent
                    g: torch.Tensor,          # (H_out, C_out) cotangent
                    plan: StencilPlan | None = None,  # of (neighbors, H)
                    ) -> torch.Tensor:
    """dW[f] = sum_v table[neighbors[f, v]]^T g[v] -> (F, C_in, C_out) f32.

    table and g are float32 or bfloat16 alike; sums are float32 and taps with
    id -1 or an id past the table add nothing.  On the card the kernel reads
    the plan's lists, not ``neighbors``.  Deterministic: no atomics, a fixed
    summation order.
    """
    if table.device.type == "cpu" or plain_forced():
        return stencil_dkernel_plain(table, neighbors, g)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    _check_args(table, neighbors, g)
    f, h_out = neighbors.shape
    h_in, c_in = table.shape
    c_out = g.shape[1]
    if plan is None or plan.verts is None:
        plan = make_stencil_plan(neighbors, h_in)
    _check_plan(plan, neighbors)
    out = torch.empty((f, c_in, c_out), dtype=torch.float32, device=table.device)
    splits, chunk = vertex_splits(f, c_in, c_out, h_out)
    partial = (torch.empty((splits, f, c_in, c_out), dtype=torch.float32,
                           device=table.device) if splits > 1 else None)
    fn = entry("stencil_dkernel", "hpl_stencil_dkernel", "piipppiipiiippip")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.data_ptr(), h_in, c_in, plan.verts.data_ptr(),
            plan.rows.data_ptr(), plan.counts.data_ptr(), f,
            plan.verts.stride(0),
            g.data_ptr(), c_out, chunk, splits,
            partial.data_ptr() if partial is not None else None,
            out.data_ptr(), _DTYPES[table.dtype], stream)
    check("stencil_dkernel", rc, "stencil_dkernel launch")
    stencil_dkernel.launches += 1
    return out


stencil_dkernel.launches = 0
