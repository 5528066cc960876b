"""Multi-device training over ``torch.distributed``: meshes of ranks,
multi-process initialization and the data-parallel train step.

Port of ``hplflownet_tpu/parallel``.  One process drives one device; the
batch axis is split over the ``data`` mesh axis and the gradients are summed
by one all-reduce a step (NCCL between cards, gloo on the CPU).  JAX's
``lattice_sharded_forward`` (the lattice's vertex axis split over the
``lattice`` axis) is not ported yet: ranks on that axis repeat the same work.
"""

from .mesh import Mesh, make_mesh  # noqa: F401
from .distributed import (initialize, global_mesh,  # noqa: F401
                          process_local_batch_slice)
from .data_parallel import (make_dp_train_step, shard_batch,  # noqa: F401
                            loss_and_grad)
