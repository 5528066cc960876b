"""hplflownet_tpu_torch — HPLFlowNet scene flow in PyTorch, with CUDA kernels
written by hand for Hopper (sm_90a).

The port of ``hplflownet_tpu`` (JAX + Pallas on a TPU), which stays beside it
as the reference.  It imports ``torch`` and numpy only — never jax, flax or
anything of the JAX package — and mirrors that package's module names:

* ``lattice/``  the permutohedral-lattice pyramid, built on the device with
  sorts and ``searchsorted`` joins (window-free, static capacities);
* ``ops/``      splat / blur / slice and the correlation BCL, each with its
  hand-derived backward (autograd Functions, scatter-free);
* ``kernels/``  the CUDA kernels (``csrc/*.cu``), each beside its plain
  PyTorch version and built with ``nvcc`` at first use;
* ``models/``   ``HPLFlowNet`` with the flax parameter names and layouts,
  the EPE3D loss and the init schemes;
* ``train/``    the train and eval steps (hand-written Adam) and the LR
  schedules;
* ``parallel/`` data-parallel training over ``torch.distributed``;
* ``data/``     datasets, loader, the offline preprocess and scene-export
  CLIs;
* ``pipeline``  ``make_lattice_spec`` and ``flow_forward``;
* ``params``    carries JAX parameter and optimizer trees across, both ways;
* ``bench``     the flagship's pairs/s and train ms/step as one JSON line.

Entry points run on the CUDA card unless the caller passes ``device="cpu"``.
Importing the package needs neither ``nvcc`` nor a card.
"""

__version__ = "0.1.0"

from .device import resolve_device  # noqa: F401
