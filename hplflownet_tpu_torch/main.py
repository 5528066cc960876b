"""CLI: ``python -m hplflownet_tpu_torch.main <config.yaml>``.

The port's counterpart of the repository's ``main.py``: trains or evaluates
per a config of ``configs/`` (the same schema).  Runs on the CUDA card
unless the config says ``platform: cpu``.
"""

import sys

from .train.driver import run
from .utils.config import parse_args_from_yaml


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 1:
        print("usage: python -m hplflownet_tpu_torch.main <config.yaml>",
              file=sys.stderr)
        return 2
    run(parse_args_from_yaml(argv[0]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
