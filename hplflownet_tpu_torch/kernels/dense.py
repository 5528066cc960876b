"""``dense_gemm``: the dense layers' product with its epilogue.

    out = act(x @ weight + bias)                               -> (M, N)

Replaces no Pallas kernel: the JAX package leaves this product to XLA's
``dot``.  On CUDA tensors the wrapper launches ``csrc/dense_gemm.cu``
(bf16 operands on the tensor cores, float32 sums; float32 operands on an
exact SIMT path), on the operands :func:`gemm_input` and :func:`gemm_weight`
make; on CPU tensors, and under ``plain_kernels()``, it runs
:func:`dense_gemm_plain`.  The kernel source states its bound on the card
and what its design does about it.
"""

from __future__ import annotations

import torch

from . import plain_forced
from ._build import check, entry

__all__ = ["dense_gemm", "dense_gemm_plain", "gemm_input", "gemm_weight",
           "uses_kernel"]

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def dense_gemm_plain(x, weight, bias=None, act_slope=None,
                     out_dtype=torch.float32, dtype=torch.bfloat16):
    """Plain PyTorch version: both operands rounded to ``dtype`` and
    multiplied in float32 (exact for bf16 inputs: "bf16 inputs, float32
    accumulation"), then the bias, the activation (jax.nn's rules at 0:
    ``x > 0`` for ReLU, ``x >= 0`` for the leaky slope) and the cast, each
    in float32."""
    f32 = torch.float32
    y = x.to(dtype).to(f32) @ weight.to(dtype).to(f32)
    if bias is not None:
        y = y + bias
    if act_slope is not None:
        if act_slope == 0.0:
            y = torch.where(y > 0, y, 0.0)
        else:
            y = torch.where(y >= 0, y, act_slope * y)
    return y.to(out_dtype)


def _check_args(x, weight, bias, dtype, out_dtype):
    if dtype not in _DTYPES or out_dtype not in _DTYPES:
        raise TypeError(f"dtype and out_dtype must be float32 or bfloat16, "
                        f"got {dtype} and {out_dtype}")
    if not (x.is_floating_point() and weight.is_floating_point()):
        raise TypeError(f"x and weight must be floating, got {x.dtype} and "
                        f"{weight.dtype}")
    if x.dim() != 2 or weight.dim() != 2 or x.shape[1] != weight.shape[0]:
        raise ValueError(f"expected x (M, K) and weight (K, N), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if weight.device != x.device:
        raise ValueError("x and weight must be on one device")
    if bias is not None:
        if bias.dtype != torch.float32 or bias.shape != (weight.shape[1],):
            raise ValueError("bias must be float32 of shape (N,)")
        if bias.device != x.device or not bias.is_contiguous():
            raise ValueError("bias must be contiguous, on x's device")


def uses_kernel(x: torch.Tensor) -> bool:
    """Whether :func:`dense_gemm` launches the kernel for input ``x``."""
    return x.device.type == "cuda" and not plain_forced()


def _padded_k(k: int) -> int:
    return -(-k // 8) * 8


def gemm_input(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` (M, K) as the kernel reads it: (M, Kp) in ``dtype``, contiguous
    and 16-byte aligned, Kp = K rounded up to a multiple of 8 with zero
    channels: rows of whole 16-byte chunks in either dtype, which the bf16
    route's TMA and the float32 route's vector loads ask."""
    m, k = x.shape
    kp = _padded_k(k)
    if kp != k:
        xp = torch.zeros((m, kp), dtype=dtype, device=x.device)
        xp[:, :k].copy_(x)
        return xp
    xc = x.to(dtype).contiguous()
    return xc if xc.data_ptr() % 16 == 0 else xc.clone()


def gemm_weight(weight: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``weight`` (K, N) as the kernel reads it: transposed, (N, Kp) in
    ``dtype``, Kp as :func:`gemm_input`'s: one copy that also makes the
    cast."""
    k, n = weight.shape
    kp = _padded_k(k)
    wt = (torch.zeros if kp != k else torch.empty)(
        (n, kp), dtype=dtype, device=weight.device)
    wt[:, :k].copy_(weight.t())
    return wt


def dense_gemm(x: torch.Tensor,          # (M, K), any float dtype
               weight: torch.Tensor,     # (K, N), any float dtype
               bias: torch.Tensor | None = None,   # (N,) f32
               act_slope: float | None = None,
               out_dtype: torch.dtype = torch.float32,
               dtype: torch.dtype = torch.bfloat16,
               wt: torch.Tensor | None = None) -> torch.Tensor:
    """act(x @ weight + bias) -> (M, N) in ``out_dtype``, the operands
    rounded to ``dtype`` (bfloat16 or float32) and summed in float32.

    ``act_slope`` None = linear; 0.0 = ReLU; otherwise LeakyReLU with that
    negative slope.  ``wt``, where given, is ``gemm_weight(weight, dtype)``
    made by a caller that keeps it (the dense layers' backward reads it);
    the wrapper makes it otherwise.
    """
    if x.device.type == "cpu" or plain_forced():
        return dense_gemm_plain(x, weight, bias, act_slope, out_dtype, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no kernel for device {x.device}")
    _check_args(x, weight, bias, dtype, out_dtype)
    m = x.shape[0]
    n = weight.shape[1]
    xc = gemm_input(x, dtype)
    if wt is None:
        wt = gemm_weight(weight, dtype)
    elif wt.shape != (n, xc.shape[1]) or wt.dtype != dtype:
        raise ValueError(f"wt must be ({n}, {xc.shape[1]}) {dtype}, got "
                         f"{tuple(wt.shape)} {wt.dtype}")
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    if act_slope is None:
        act, slope = 0, 0.0
    elif act_slope == 0.0:
        act, slope = 1, 0.0
    else:
        act, slope = 2, float(act_slope)
    fn = entry("dense_gemm", "hpl_dense_gemm", "piipipifpiip")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(xc.data_ptr(), m, xc.shape[1], wt.data_ptr(), n,
            bias.data_ptr() if bias is not None else None, act, slope,
            out.data_ptr(), _DTYPES[dtype], _DTYPES[out_dtype], stream)
    check("dense_gemm", rc, "dense_gemm launch")
    dense_gemm.launches += 1
    dense_gemm.rows += m
    return out


dense_gemm.launches = 0
dense_gemm.rows = 0     # output rows over the launches
