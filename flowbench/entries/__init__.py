"""How each kind of request drives the program: ``<entry>.py`` per entry.

A mix names its entry (``"entry": "forward"``); the harness imports
``flowbench.entries.<entry>`` and makes its ``Session(cfg, capacities,
mix, pool, params, seed, device[, program])``.  A session holds the
program, the pool of requests and what the window produced:

* ``warm(order)``: the set-up's calls (the shapes the window uses);
* ``call(k) -> bool``: one request on pool pair k, False if it failed;
* ``release()``: drop the program's state from the card;
* ``check() -> dict``: the numbers that decide ``correct``, each
  ``{"value": v}``, from the plain reference (``flowbench.reference``);
* ``work(k) -> list``: the reference's log of products for pool pair k
  (``flowbench.work``).
"""
