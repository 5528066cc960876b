"""Lattice-axis sharding: one cloud pair's lattice work split over ranks.

Port of ``hplflownet_tpu/parallel/lattice_parallel.py``.  For clouds far
beyond the reference's 8192 points a single pair's lattice work dominates,
and two mechanisms split it over the ``lattice`` axis of a mesh:

* **Pyramid probes** (the build's largest work, the stencil sort-merge
  joins) run under :func:`hplflownet_tpu_torch.lattice.probe_sharding`:
  each rank probes its share of the stencil taps against the whole,
  replicated key table, and an all-gather assembles the tables.
* **Model compute** runs under
  :func:`hplflownet_tpu_torch.ops.bcl.vertex_sharding`: every blur and
  correlation BCL computes its share of the output vertices (stencil plans
  made for those columns) and all-gathers the rows; splat, slice and the
  point-wise layers stay replicated.  JAX leaves this partition to GSPMD
  through sharding constraints; eager PyTorch makes it explicitly.

Every rank takes the same (replicated) points and returns the same
(replicated) flow.  The tap-sharded tables equal the unsharded ones, and
the stencil kernels compute each output row on its own, but the dense
layers of a sharded correlation run on a subset of the rows, and a GEMM
on fewer rows may sum in another order on the card: the flow is then
close to the unsharded one, not equal to it (the tests and the chip smoke
hold it to a stated bound).  At one rank it is the unsharded flow bit for
bit.  The collectives run on the mesh's process group: NCCL between
cards, gloo on the CPU and for ranks sharing one card.  Forward only, as
in JAX.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch.func import functional_call

from ..lattice.build import LatticeSpec, build_pyramid, probe_sharding
from ..ops.bcl import vertex_sharding
from .mesh import Mesh

__all__ = ["lattice_sharded_forward"]


def lattice_sharded_forward(model, spec: LatticeSpec, mesh: Mesh,
                            lattice_axis: str = "lattice"):
    """A single-pair forward with the lattice work split over
    ``lattice_axis`` -> ``fn(params, pc1, pc2) -> flow``.

    ``params`` maps ``state_dict`` names to tensors (a train state's
    parameters), or is None for the model's own; ``pc1``/``pc2`` are (N, d)
    arrays or tensors, moved to the model's device.  Every rank of the
    axis calls ``fn`` with the same inputs.  Use it for big single clouds;
    batches go over the ``data`` axis instead (``make_dp_train_step``).
    With one rank on the axis, or a mesh without a process group, ``fn`` is
    ``pipeline.flow_forward`` bit for bit.
    """
    device = next(model.parameters()).device

    def forward(params: Mapping[str, torch.Tensor] | None, pc1, pc2):
        with torch.inference_mode():
            pc1 = torch.as_tensor(pc1).to(device=device, dtype=torch.float32)
            pc2 = torch.as_tensor(pc2).to(device=device, dtype=torch.float32)
            with probe_sharding(mesh, lattice_axis):
                scales = build_pyramid(spec, pc1, pc2, adjoint_plans=False)
            with vertex_sharding(mesh, lattice_axis):
                if params is None:
                    return model(pc1, pc2, scales)
                return functional_call(model, dict(params), (pc1, pc2, scales))

    return forward
