"""Host-side data pipeline: datasets, transforms, loader, IO.

The port's copy of ``hplflownet_tpu/data``: numpy only.  The host pipeline
stops at sampled point clouds — the lattice is built on the device in the
step — so workers only load .npy files and run numpy augmentation and
sampling.
"""

from .transforms import ProcessData, Augmentation  # noqa: F401
from .datasets import FlyingThings3DSubset, KITTI, DATASETS  # noqa: F401
from .loader import BatchLoader  # noqa: F401
