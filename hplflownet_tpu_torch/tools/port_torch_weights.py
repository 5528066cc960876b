"""The reference's PyTorch checkpoint (``ours.pth.tar``) as the port's parameters.

    python -m hplflownet_tpu_torch.tools.port_torch_weights ours.pth.tar \\
        <ckpt_dir> [--arch HPLFlowNet]

Port of ``tools/port_torch_weights.py``: the reference's state dict goes
into the port's parameters under the flax names, by the JAX tool's layout
rules (channels-last, stencil-tap-major):

  torch Conv1d (out, in, 1)          -> dense{i}_kernel (in, out)
  torch Conv2d (out, in, F, 1)       -> conv0_kernel / blur0_kernel (F, in, out)
  torch Conv2d (out, in, 1, 1)       -> conv{i}_kernel (in, out)
  torch Conv3d (out, in, 1, Cc, 1)   -> corr0_kernel (Cc, in, out)
  torch Conv3d (out, in, 1, 1, 1)    -> corr{i}_kernel (in, out)
  BilateralConvFlex.bias             -> slice_bias

Module names map one for one (conv1..conv4, bcn1..bcn7, bcn1_..bcn7_,
corr1..corr5, corr*_refine); the reference's checkpoints are
DataParallel-wrapped (a ``module.`` prefix).  The parameters are loaded
into ``--arch`` strictly (every name and shape must match) and saved with
``train.checkpoint.CheckpointIO`` as a fresh train state (epoch 0, Adam's
moments zero) named ``checkpoint`` and ``model_best`` in ``<ckpt_dir>``,
which ``python -m hplflownet_tpu_torch.main`` resumes or evaluates from.
The checkpoint is read with ``torch.load(weights_only=True)``.
"""

from __future__ import annotations

import argparse
import re

import numpy as np
import torch

from .timing import ARCHS

__all__ = ["convert_weight", "port_state_dict", "load_reference",
           "port_checkpoint", "main"]


def convert_weight(w: np.ndarray) -> np.ndarray:
    """A torch conv weight in the port's (flax) kernel layout."""
    w = np.asarray(w)
    if w.ndim == 3:                       # Conv1d (out, in, 1)
        _expect(w.shape[2] == 1, w)
        return w[:, :, 0].T
    if w.ndim == 4:                       # Conv2d (out, in, F, 1)
        _expect(w.shape[3] == 1, w)
        if w.shape[2] == 1:
            return w[:, :, 0, 0].T
        return np.transpose(w[:, :, :, 0], (2, 1, 0))     # (F, in, out)
    if w.ndim == 5:                       # Conv3d (out, in, 1, Cc, 1)
        _expect(w.shape[2] == 1 and w.shape[4] == 1, w)
        if w.shape[3] == 1:
            return w[:, :, 0, 0, 0].T
        return np.transpose(w[:, :, 0, :, 0], (2, 1, 0))  # (Cc, in, out)
    raise ValueError(f"unexpected weight shape {w.shape}")


def _expect(ok: bool, w) -> None:
    if not ok:
        raise ValueError(f"unexpected weight shape {w.shape}")


def _key(prefix: str, idx: int, kind: str) -> str:
    return f"{prefix}{idx}_{'kernel' if kind == 'weight' else 'bias'}"


def port_state_dict(state_dict: dict) -> dict:
    """The reference's state dict -> the flax tree ``{"params": {module:
    {name: float32 array}}}`` (what ``params.params_from_jax`` reads)."""
    params: dict = {}

    def put(mod, key, kind, t):
        value = convert_weight(t) if kind == "weight" else t
        params.setdefault(mod, {})[key] = np.asarray(value, dtype=np.float32)

    for name, tensor in state_dict.items():
        name = re.sub(r"^module\.", "", name)
        t = np.asarray(tensor)
        parts = name.split(".")
        mod, kind = parts[0], parts[-1]
        if any(s in name for s in ("feat_indices", "out_indices", "feat1_indices")):
            continue                       # index buffers, not parameters
        if mod.startswith("conv") and "composed_module" in name:
            # point MLPs: conv1.0.composed_module.0.weight, conv2.composed_module...
            idx = int(parts[1]) if parts[1].isdigit() else 0
            put(mod, _key("dense", idx, kind), kind, t)
        elif mod.startswith("conv") and parts[1] in ("weight", "bias"):
            put(mod, _key("dense", 0, kind), kind, t)   # the plain Conv1d head
        elif "_refine" in mod:
            put(mod, _key("dense", int(parts[1]), kind), kind, t)
        elif mod.startswith("bcn"):
            if parts[1] == "bias":
                params.setdefault(mod, {})["slice_bias"] = np.asarray(t, np.float32)
                continue
            if parts[1] != "blur_conv":
                raise ValueError(f"unmapped parameter {name}")
            put(mod, _key("conv", int(parts[2]), kind), kind, t)
        elif mod.startswith("corr"):
            prefix = "corr" if parts[1] == "corr_conv" else "blur"
            put(mod, _key(prefix, int(parts[2]), kind), kind, t)
        else:
            raise ValueError(f"unmapped parameter {name}")
    return {"params": params}


def load_reference(path: str) -> dict:
    """The state dict of a reference checkpoint, as numpy arrays."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    state_dict = ckpt.get("state_dict", ckpt)
    return {k: v.numpy() for k, v in state_dict.items()}


def port_checkpoint(state_dict: dict, ckpt_dir: str,
                    arch: str = "HPLFlowNet"):
    """Load the ported parameters into ``arch`` (on the CPU, strictly) and
    save them as a fresh train state in ``ckpt_dir`` -> the model."""
    from ..models import MODELS
    from ..params import params_from_jax
    from ..train.checkpoint import CheckpointIO
    from ..train.step import create_train_state
    model = MODELS[arch](ARCHS[arch][0], device="cpu")
    params_from_jax(port_state_dict(state_dict), model)
    state = create_train_state(model, device="cpu")
    CheckpointIO(ckpt_dir).save(state, epoch=0, min_loss=float("inf"),
                                is_best=True)
    return model


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checkpoint")
    ap.add_argument("ckpt_dir")
    ap.add_argument("--arch", choices=sorted(ARCHS), default="HPLFlowNet")
    args = ap.parse_args(argv)
    model = port_checkpoint(load_reference(args.checkpoint), args.ckpt_dir,
                            args.arch)
    n = sum(p.numel() for p in model.parameters())
    print(f"ported {n / 1e6:.2f}M parameters -> {args.ckpt_dir}", flush=True)
    return model


if __name__ == "__main__":
    main()
