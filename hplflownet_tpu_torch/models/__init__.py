"""Models of the port: the 7-scale HPLFlowNet and the 5-scale
HPLFlowNetShallow, their loss and init schemes, SPLATNet3D (one cloud's
per-point part logits), and the registry the driver and the benchmark look
models up in by name."""

from .hplflownet import HPLFlowNet  # noqa: F401
from .hplflownet_shallow import HPLFlowNetShallow  # noqa: F401
from .layers import PointMLP  # noqa: F401
from .losses import epe3d_loss  # noqa: F401
from .splatnet import SPLATNet3D  # noqa: F401

MODELS = {
    "HPLFlowNet": HPLFlowNet,
    "HPLFlowNetShallow": HPLFlowNetShallow,
    "SPLATNet3D": SPLATNet3D,
}


def get_model(name: str, **kwargs):
    if name not in MODELS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(MODELS)}")
    return MODELS[name](**kwargs)
