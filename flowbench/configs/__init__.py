"""Model configurations, one JSON file each, found by name."""

from __future__ import annotations

import json
from pathlib import Path

__all__ = ["CONFIG_DIR", "load_config"]

CONFIG_DIR = Path(__file__).resolve().parent


def load_config(name: str) -> dict:
    with open(CONFIG_DIR / f"{name}.json") as fd:
        return json.load(fd)
