"""YAML config system (reference: cmd_args.py + utils/easydict.py).

The port's copy of ``hplflownet_tpu/utils/config.py``: the same config
schema (configs/*.yaml) and the same normalisation.  Two keys of the JAX
configs map onto the port:

* ``platform: cpu`` runs on the CPU (``device = "cpu"``); without it the
  driver runs on the CUDA card;
* ``matmul_precision`` is accepted and logged; the driver keeps TF32 off
  whatever it says, as float32 parity with JAX needs full float32 products.

``yaml`` is imported by :func:`parse_args_from_yaml` only: a ``Config``
built from a dict needs no YAML parser.  Malformed configs raise
``ValueError``.
"""

from __future__ import annotations

import numpy as np

from ..models.init import INIT_SCHEMES

__all__ = ["Config", "parse_args_from_yaml", "postprocess"]

MODEL_NAMES = ("HPLFlowNet", "HPLFlowNetShallow")
DATASET_NAMES = ("FlyingThings3DSubset", "KITTI")


class Config(dict):
    """Attribute-access dict; nested dicts/lists are wrapped recursively."""

    def __init__(self, d=None, **kwargs):
        super().__init__()
        d = dict(d or {}, **kwargs)
        for k, v in d.items():
            self[k] = v

    @staticmethod
    def _wrap(v):
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        if isinstance(v, (list, tuple)):
            return type(v)(Config._wrap(x) for x in v)
        return v

    def __setitem__(self, k, v):
        super().__setitem__(k, Config._wrap(v))

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v

    def get_or(self, k, default):
        return self[k] if k in self else default


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def postprocess(args: Config) -> Config:
    """Validation + normalization (reference: cmd_args.py:23-56)."""
    args.allow_less_points = bool(args.get_or("allow_less_points", False))

    _require(args.get_or("arch", None) in MODEL_NAMES,
             f"unknown arch {args.get_or('arch', None)}")
    _require(args.get_or("dataset", None) in DATASET_NAMES,
             f"unknown dataset {args.get_or('dataset', None)}")
    _require("data_root" in args, "config must set data_root")

    if not args.evaluate:
        args.init = args.get_or("init", "xavier")
        args.gain = float(args.get_or("gain", 1.0))
        # honored by models.init.reinit_params (reference main_utils.py:33-50)
        _require(args.init in INIT_SCHEMES,
                 f"initialization method [{args.init}] is not implemented")

        if args.get_or("custom_lr", False):
            # reference stores these reversed; we keep ascending order
            lrs = [float(x) for x in str(args.lrs).split(",")]
            switches = [int(x) for x in str(args.lr_switch_epochs).split(",")]
            _require(len(lrs) == len(switches),
                     "lrs and lr_switch_epochs differ in length")
            _require(bool((np.diff(switches) > 0).all()),
                     "switch epochs must ascend")
            args.lrs = lrs
            args.lr_switch_epochs = switches
            args.lr = lrs[0]

    if args.evaluate:
        _require(bool(args.get_or("resume", False)), "evaluation requires resume")

    args.dim = int(args.get_or("dim", 3))
    args.batch_size = int(args.get_or("batch_size", 1))
    args.matmul_precision = args.get_or("matmul_precision", "default")
    if args.get_or("platform", None) == "cpu":
        args.device = "cpu"
    return args


def parse_args_from_yaml(yaml_path: str) -> Config:
    import yaml
    with open(yaml_path) as fd:
        raw = yaml.safe_load(fd)
    return postprocess(Config(raw))
