"""Helpers of the benchmark's own tests (run from the repository root:
``python -m pytest flowbench/tests``)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def run_cell(args, env_extra=None, cwd=ROOT, timeout=900):
    """``python -m flowbench.run <args>`` in a fresh interpreter."""
    env = dict(os.environ, **(env_extra or {}))
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "-m", "flowbench.run", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


def last_json(stdout: str) -> dict:
    return json.loads(stdout.strip().splitlines()[-1])
