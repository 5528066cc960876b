"""lattice.idle_ms.train: the card's idle time per step of the train entry
in the lattice build, in ms: the span ``lattice.build`` and every span
inside it: ``lattice.scale<i>``, ``lattice.dedup``, ``lattice.tables``,
``lattice.next``; each gap between device operations charged to the
innermost span open on the calling thread at its midpoint.  From a profiled
stretch of the program's spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "train", "layers", "lattice", "idle_ms")
