"""Checkpoints of a ``TrainState`` (reference: main_utils.py:54-64,
main.py:116-129), with ``torch.save`` in place of the JAX package's Orbax.

The policy is the JAX package's: ``checkpoint`` every epoch, a kept copy
``checkpoint_{epoch}`` every 10 epochs (``epoch % 10 == 1``), and
``model_best`` for the best validation loss.  Each is one file,
``<name>.pt``, written to a temporary name and renamed into place.  The
state is stored under the flax names: parameters keyed as
``params.params_from_jax`` gives them (``"bcn1.conv0_kernel"``), Adam's
moments as ``params.opt_state_from_jax`` does, all float32 on the CPU.
"""

from __future__ import annotations

import os
import os.path as osp

import torch

from .step import AdamState, TrainState

__all__ = ["CheckpointIO"]


def _to_cpu(tree: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}


def _payload(state: TrainState, epoch: int, min_loss: float) -> dict:
    opt = state.opt_state
    return {"state": {"params": _to_cpu(state.params),
                      "opt_state": {"mu": _to_cpu(opt.mu), "nu": _to_cpu(opt.nu),
                                    "count": opt.count.detach().cpu(),
                                    "learning_rate": opt.learning_rate.detach().cpu()},
                      "step": state.step.detach().cpu()},
            "meta": {"epoch": int(epoch), "min_loss": float(min_loss)}}


class CheckpointIO:
    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = osp.abspath(ckpt_dir)
        os.makedirs(self.ckpt_dir, exist_ok=True)

    def _path(self, name: str) -> str:
        return osp.join(self.ckpt_dir, f"{name}.pt")

    def _write(self, name: str, payload: dict) -> None:
        tmp = self._path(name) + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, self._path(name))

    def save(self, state: TrainState, epoch: int, min_loss: float,
             is_best: bool = False, keep_every: int = 10):
        payload = _payload(state, epoch, min_loss)
        self._write("checkpoint", payload)
        if epoch % keep_every == 1:
            self._write(f"checkpoint_{epoch}", payload)
        if is_best:
            self._write("model_best", payload)

    def restore(self, template: TrainState, name: str = "checkpoint"):
        """Restore into the structure of ``template`` (the state the train
        step's ``init_state`` makes), on its device: the same parameter
        names and shapes, bit for bit what was saved.

        Returns (state, epoch, min_loss).
        """
        dev = template.step.device
        out = torch.load(self._path(name), map_location=dev, weights_only=True)
        st, opt = out["state"], out["state"]["opt_state"]
        for what, got in (("params", st["params"]), ("mu", opt["mu"]),
                          ("nu", opt["nu"])):
            want = {k: tuple(v.shape) for k, v in template.params.items()}
            have = {k: tuple(v.shape) for k, v in got.items()}
            if have != want:
                diff = sorted(set(have.items()) ^ set(want.items()))
                raise ValueError(f"{self._path(name)}: {what} do not match the "
                                 f"model: {diff[:5]}")
        state = TrainState(
            params=st["params"],
            opt_state=AdamState(mu=opt["mu"], nu=opt["nu"], count=opt["count"],
                                learning_rate=opt["learning_rate"]),
            step=st["step"])
        meta = out["meta"]
        return state, int(meta["epoch"]), float(meta["min_loss"])

    def exists(self, name: str = "checkpoint") -> bool:
        return osp.isfile(self._path(name))
