"""How each kind of request drives the program: ``<entry>.py`` per entry.

A mix names its entry module (``"entry": "forward"``); the harness imports
``flowbench.entries.<entry>``.  The module gives:

* ``init_params(cfg, seed, device) -> dict``: the weights, made from the
  seed (the two existing entries re-export ``reference.model.init_params``);
* ``Session(cfg, capacities, mix, pool, params, seed, device[,
  program])``: the program, the pool of requests (what the mix's pool
  maker made) and what the window produced;
* ``CONTROL`` and ``FAULTS`` (``{name: class}``), where
  ``flowbench/control.py`` and ``flowbench/faults.py`` have no row for the
  entry: the control and the planted faults, each with the interface of
  the entry's ``Program`` (looked up through :class:`ByEntry`).

A session's class attribute ``entry`` is its request kind, ``"forward"``
or ``"train"``: the harness profiles that kind's number of calls and the
metric readers take the run as of that kind, whatever the module's name.
A session has:

* ``warm(order)``: the set-up's calls (the shapes the window uses);
* ``call(k) -> bool``: one request on pool item k, False if it failed;
* ``overflowing() -> set``: pool items whose work the program dropped;
* ``release()``: drop the program's state from the card;
* ``check() -> dict``: the numbers that decide ``correct``, each
  ``{"value": v}``, from the plain reference (``flowbench.reference``);
* ``work(k) -> list``: the reference's log of products for pool item k
  (``flowbench.work``).
"""

from __future__ import annotations

import importlib

__all__ = ["ByEntry"]


class ByEntry(dict):
    """Rows keyed by entry module name; an entry without a row brings its
    own, the module-level ``attr`` of ``flowbench.entries.<entry>``."""

    def __init__(self, attr: str, rows: dict):
        super().__init__(rows)
        self.attr = attr

    def __missing__(self, entry: str):
        return getattr(importlib.import_module(f"{__name__}.{entry}"), self.attr)
