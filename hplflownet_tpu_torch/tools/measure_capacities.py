"""Per-scale lattice vertex counts measured on a config's dataset.

    python -m hplflownet_tpu_torch.tools.measure_capacities <config.yaml>
        [--num-batches 16] [--slack 1.3] [--align 256] [--device cpu]

Port of ``tools/measure_capacities.py``.  Static capacities trade memory
for the reference's dynamic hash counts; this tool reads the config's
validation set (its dataset, ``data_process`` and ``num_points``) through
``train.driver.measure_capacities_from_loader`` so that a config can set
tight ``lattice_capacities``.  That function doubles a scale that
overflows its first guess and builds again, where the JAX package's probe
reads clamped counts (ROADMAP Queue 3, reference-side deviations).  Runs
on the card unless ``--device cpu`` (or the config's ``platform: cpu``).
Prints ``lattice_capacities: [...]``.
"""

from __future__ import annotations

import argparse

from ..data import DATASETS, BatchLoader, ProcessData
from ..train.driver import measure_capacities_from_loader

__all__ = ["val_loader", "run", "main"]


def val_loader(args) -> BatchLoader:
    """The config's validation set in order, every sample once."""
    ds_kwargs = dict(num_points=args.num_points, data_root=args.data_root,
                     strict=bool(args.get_or("strict", True)))
    if args.dataset == "KITTI":
        ds_kwargs["remove_ground"] = bool(args.get_or("remove_ground", True))
    if args.dataset == "FlyingThings3DSubset":
        ds_kwargs["full"] = bool(args.get_or("full", False))
    transform = ProcessData(args.data_process, args.num_points,
                            args.allow_less_points)
    dataset = DATASETS[args.dataset](train=False, transform=transform,
                                     **ds_kwargs)
    return BatchLoader(dataset, args.batch_size, shuffle=False,
                       num_threads=args.get_or("workers", 4), drop_last=False)


def run(args, num_batches: int = 16, slack: float = 1.3, align: int = 256,
        device=None) -> list:
    """The capacities for a parsed config (``utils.config``)."""
    return measure_capacities_from_loader(
        args.scales_filter_map, val_loader(args), num_batches=num_batches,
        slack=slack, align=align, dim=args.dim,
        device=device or args.get_or("device", None))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("config")
    ap.add_argument("--num-batches", type=int, default=16)
    ap.add_argument("--slack", type=float, default=1.3)
    ap.add_argument("--align", type=int, default=256)
    ap.add_argument("--device", default=None, help="cpu, or the card (default)")
    cli = ap.parse_args(argv)
    from ..utils.config import parse_args_from_yaml
    caps = run(parse_args_from_yaml(cli.config), cli.num_batches, cli.slack,
               cli.align, cli.device)
    print("lattice_capacities:", caps, flush=True)
    return caps


if __name__ == "__main__":
    main()
