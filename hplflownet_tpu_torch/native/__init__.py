"""The host (C++) lattice builder, bound through ctypes.

``bindings.HostLatticeBuilder`` builds a cloud's vertex table and its
neighbour and correlation tables on the host, equal to the device
builder's; ``python -m hplflownet_tpu_torch.native`` checks it against the
device builder on a synthetic pair (``check.py``).
"""

from .bindings import HostLatticeBuilder, load_library  # noqa: F401
