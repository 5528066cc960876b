"""``stencil_gather_matmul``: the lattice blur / correlation contraction.

    out[v] = act(sum_f table[nb[f, v]] @ weight[f] + bias)     -> (H_out, C_out)

Replaces ``hplflownet_tpu/ops/pallas_stencil.py`` ``stencil_gather_matmul``
(:270; ``pallas_call`` :169, body ``_kernel`` :93).  On CUDA tensors the
wrapper launches ``csrc/stencil_gather_matmul.cu``; on CPU tensors it runs
:func:`stencil_gather_matmul_plain`.  The kernel walks the output rows in
the stencil plan's row order (``kernels.stencil_plan``); the caller passes
the plan (made from the table when it is None).  The kernel source states
its bound on the card (operations) and what its design does about it.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry
from .stencil_plan import StencilPlan, make_stencil_plan

__all__ = ["stencil_gather_matmul", "stencil_gather_matmul_plain",
           "apply_epilogue"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def apply_epilogue(x: torch.Tensor, bias, act_slope, out_dtype) -> torch.Tensor:
    """Bias add + activation + cast, in float32.

    ``act_slope`` None = linear; 0.0 = ReLU; otherwise LeakyReLU with that
    negative slope (``x >= 0 ? x : slope * x``, the JAX rule).
    """
    x = x.to(torch.float32)
    if bias is not None:
        x = x + bias.to(torch.float32)
    if act_slope is not None:
        if act_slope == 0.0:
            x = torch.clamp_min(x, 0.0)
        else:
            x = torch.where(x >= 0.0, x, act_slope * x)
    return x.to(out_dtype)


def stencil_gather_matmul_plain(table, neighbors, weight, bias=None,
                                act_slope=None, out_dtype=torch.float32):
    """Plain PyTorch version: materialise the (H_out, F, C_in) spread.

    Rows are gathered through a zero row 0 (ids shifted by +1), and the
    products run in float32 — exact for bf16 inputs, so this is "bf16
    inputs, float32 accumulation".
    """
    f, h_out = neighbors.shape
    c_in, c_out = weight.shape[1], weight.shape[2]
    pad = torch.cat([table.new_zeros(1, c_in), table]).to(torch.float32)
    spread = pad[(neighbors.t() + 1).long()]                   # (H_out, F, C_in)
    x = spread.reshape(h_out, f * c_in) @ weight.to(torch.float32).reshape(
        f * c_in, c_out)
    return apply_epilogue(x, bias, act_slope, out_dtype)


def _check_args(table, neighbors, weight, bias, out_dtype, order=None):
    dev = table.device
    if table.dtype not in _DTYPES or weight.dtype != table.dtype:
        raise TypeError(f"table and weight must share float32 or bfloat16, got "
                        f"{table.dtype} and {weight.dtype}")
    if out_dtype not in _DTYPES:
        raise TypeError(f"out_dtype must be float32 or bfloat16, got {out_dtype}")
    if neighbors.dtype != torch.int32:
        raise TypeError(f"neighbors must be int32, got {neighbors.dtype}")
    if table.dim() != 2 or neighbors.dim() != 2 or weight.dim() != 3:
        raise ValueError("expected table (H, C_in), neighbors (F, H_out), "
                         "weight (F, C_in, C_out)")
    if weight.shape[0] != neighbors.shape[0] or weight.shape[1] != table.shape[1]:
        raise ValueError(f"shape mismatch: table {tuple(table.shape)}, "
                         f"neighbors {tuple(neighbors.shape)}, "
                         f"weight {tuple(weight.shape)}")
    ts = [table, neighbors, weight]
    if order is not None:
        if order.dtype != torch.int32 or order.shape != (neighbors.shape[1],):
            raise ValueError(f"order must be int32 of shape "
                             f"({neighbors.shape[1]},), got {order.dtype} "
                             f"{tuple(order.shape)}")
        ts.append(order)
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (weight.shape[2],):
            raise ValueError("bias must be float32 of shape (C_out,)")
        ts.append(bias)
    for t in ts:
        if t.device != dev:
            raise ValueError("all arguments must be on one device")
        if not t.is_contiguous():
            raise ValueError("arguments must be contiguous")


def stencil_gather_matmul(table: torch.Tensor,      # (H, C_in), no sentinel row
                          neighbors: torch.Tensor,  # (F, H_out) int32, -1 absent
                          weight: torch.Tensor,     # (F, C_in, C_out)
                          bias: torch.Tensor | None = None,   # (C_out,) f32
                          act_slope: float | None = None,
                          out_dtype: torch.dtype = torch.float32,
                          plan: StencilPlan | None = None,
                          ) -> torch.Tensor:
    """act(sum_f table[neighbors[f]] @ weight[f] + bias) -> (H_out, C_out).

    Inputs are float32 or bfloat16 (table and weight alike); accumulation is
    float32 and the epilogue (:func:`apply_epilogue`) runs in float32 before
    the single write in ``out_dtype``.  Taps with id -1 or an id past the
    table add nothing.  ``plan`` is the stencil plan of ``neighbors`` (for
    the negated-tap table of an input gradient, the forward table's); the
    kernel reads its ``order``, a permutation of the output rows that sets
    which rows a block takes, and the result does not depend on it.
    """
    if table.device.type == "cpu" or plain_forced():
        return stencil_gather_matmul_plain(table, neighbors, weight, bias,
                                           act_slope, out_dtype)
    if table.device.type != "cuda":
        raise ValueError(f"no kernel for device {table.device}")
    f, h_out = neighbors.shape
    h_in, c_in = table.shape
    order = (make_stencil_plan(neighbors, h_in, lists=False) if plan is None
             else plan).order
    _check_args(table, neighbors, weight, bias, out_dtype, order)
    c_out = weight.shape[2]
    out = torch.empty((h_out, c_out), dtype=out_dtype, device=table.device)
    if act_slope is None:
        act, slope = 0, 0.0
    elif act_slope == 0.0:
        act, slope = 1, 0.0
    else:
        act, slope = 2, float(act_slope)
    fn = entry("stencil_gather_matmul", "hpl_stencil_gather_matmul", "piippiipipifpiip")
    stream = torch.cuda.current_stream(table.device).cuda_stream
    rc = fn(table.data_ptr(), h_in, c_in, neighbors.data_ptr(),
            order.data_ptr(), f, h_out,
            weight.data_ptr(), c_out,
            bias.data_ptr() if bias is not None else None,
            act, slope, out.data_ptr(), _DTYPES[table.dtype],
            _DTYPES[out_dtype], stream)
    check("stencil_gather_matmul", rc, "stencil_gather_matmul launch")
    stencil_gather_matmul.launches += 1
    return out


stencil_gather_matmul.launches = 0
