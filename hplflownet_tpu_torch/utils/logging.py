"""File+stdout logger and running meters (reference: main_utils.py:67-118).

The port's own copy of ``hplflownet_tpu/utils/logging.py``.
"""

from __future__ import annotations

import sys

__all__ = ["Logger", "AverageMeter", "confirm"]


def confirm(question: str, default: bool | None = None) -> bool:
    """Interactive yes/no prompt (reference main_utils.py:121-151 UX).

    ``default`` is returned on empty input; ``None`` keeps asking.
    """
    suffix = {True: " [Y/n] ", False: " [y/N] ", None: " [y/n] "}[default]
    answers = {"y": True, "ye": True, "yes": True,
               "n": False, "no": False}
    while True:
        reply = input(question + suffix).strip().lower()
        if not reply and default is not None:
            return default
        if reply in answers:
            return answers[reply]
        print("Please answer 'y' or 'n'.")


class Logger:
    def __init__(self, out_fname: str | None = None):
        self.out_fd = open(out_fname, "w") if out_fname else None

    def log(self, msg, end="\n"):
        if self.out_fd is not None:
            self.out_fd.write(str(msg) + end)
            self.out_fd.flush()
        print(msg, end=end, flush=True)

    def close(self):
        if self.out_fd is not None:
            self.out_fd.close()
            self.out_fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AverageMeter:
    """Running mean of a scalar stream."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n

    @property
    def avg(self):
        return self.sum / self.count if self.count else 0.0
