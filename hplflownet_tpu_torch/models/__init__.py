"""Models of the port: the 7-scale HPLFlowNet."""

from .hplflownet import HPLFlowNet  # noqa: F401
from .layers import PointMLP  # noqa: F401
