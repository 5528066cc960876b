"""Models of the port: the 7-scale HPLFlowNet, its loss and init schemes."""

from .hplflownet import HPLFlowNet  # noqa: F401
from .layers import PointMLP  # noqa: F401
from .losses import epe3d_loss  # noqa: F401
