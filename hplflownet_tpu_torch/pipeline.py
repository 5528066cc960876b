"""End-to-end pipeline: lattice spec, then pyramid build + model forward.

Port of ``hplflownet_tpu/pipeline.py``.  ``flow_forward`` runs on the
model's device (the CUDA card unless the model was made with
``device="cpu"``) under ``torch.inference_mode()``; ``batched_flow_forward``
runs it over a (B, N, d) batch, one sample at a time.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .lattice.build import (LatticeSpec, ScaleSpec, build_pyramid,
                            default_capacities)

__all__ = ["make_lattice_spec", "flow_forward", "batched_flow_forward"]


def make_lattice_spec(scales_filter_map: Sequence[Sequence[float]],
                      capacities: Sequence[int] | None = None,
                      num_points: int | None = None,
                      d: int = 3) -> LatticeSpec:
    """A LatticeSpec from a reference-style ``scales_filter_map``.

    Each row is (scale, blur_radius, corr_filter_radius, corr_corr_radius);
    ``capacities`` fixes the static vertex capacity per scale, else it is
    measured on synthetic clouds of ``num_points``.
    """
    if capacities is None:
        if num_points is None:
            raise ValueError("need capacities or num_points")
        capacities = default_capacities(num_points, scales_filter_map, d)
    assert len(capacities) == len(scales_filter_map)
    return LatticeSpec(d=d, scales=tuple(
        ScaleSpec(scale=float(row[0]), blur_radius=int(row[1]),
                  corr_filter_radius=int(row[2]),
                  corr_corr_radius=int(row[3]), capacity=int(cap))
        for row, cap in zip(scales_filter_map, capacities)))


def _as_tensor(x, dtype, device):
    if x is None:
        return None
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def flow_forward(model, spec: LatticeSpec, pc1, pc2, valid1=None,
                 valid2=None, adjoint_plans: bool = True) -> torch.Tensor:
    """Single sample: points -> lattice pyramid -> model -> (N, 3) flow.

    ``pc1``/``pc2`` are (N, d) arrays or tensors; they are moved to the
    model's device.  Pass ``adjoint_plans=False`` for inference (skips the
    backward-only correlation tables).
    """
    device = next(model.parameters()).device
    with torch.inference_mode():
        pc1 = _as_tensor(pc1, torch.float32, device)
        pc2 = _as_tensor(pc2, torch.float32, device)
        valid1 = _as_tensor(valid1, torch.bool, device)
        valid2 = _as_tensor(valid2, torch.bool, device)
        scales = build_pyramid(spec, pc1, pc2, valid1, valid2,
                               adjoint_plans=adjoint_plans)
        return model(pc1, pc2, scales)


def batched_flow_forward(model, spec: LatticeSpec, pc1, pc2, valid1=None,
                         valid2=None) -> torch.Tensor:
    """(B, N, d) batches -> (B, N, 3) flow on the model's device.

    Each sample runs :func:`flow_forward` in turn (the JAX package maps
    over the samples with ``lax.map``: a pyramid is built per pair).
    Missing valid masks are all True.
    """
    n_batch = len(pc1)
    if valid1 is None:
        valid1 = [None] * n_batch
    if valid2 is None:
        valid2 = [None] * n_batch
    return torch.stack([flow_forward(model, spec, pc1[b], pc2[b], valid1[b],
                                     valid2[b]) for b in range(n_batch)])
