"""Multi-device runs over ``torch.distributed``: meshes of ranks,
multi-process initialization, the data-parallel train step and the
lattice-sharded forward.

Port of ``hplflownet_tpu/parallel``.  One process drives one device.  The
batch axis is split over the ``data`` mesh axis and the gradients are summed
by one all-reduce a step (NCCL between cards, gloo on the CPU).
``lattice_sharded_forward`` splits one pair's lattice work (the pyramid's
stencil probes, the blur and correlation vertices) over the ``lattice``
axis; the data-parallel step does not, and ranks sharing a ``data`` index
repeat its work.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
from .distributed import (initialize, global_mesh,  # noqa: F401
                          process_local_batch_slice)
from .data_parallel import (make_dp_train_step, shard_batch,  # noqa: F401
                            loss_and_grad)
from .lattice_parallel import lattice_sharded_forward  # noqa: F401
