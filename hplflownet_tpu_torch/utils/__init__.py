"""Config, logging, metering utilities (the port's ``hplflownet_tpu/utils``)."""

from .config import Config, parse_args_from_yaml  # noqa: F401
from .logging import Logger, AverageMeter  # noqa: F401
