"""lattice.device_ms.fwd: the card's time per pair of the forward entry in
the lattice build, in ms: the span ``lattice.build`` and every span inside
it: ``lattice.scale<i>``, ``lattice.dedup``, ``lattice.tables``,
``lattice.next``; each device operation charged to the innermost span that
launched it, counting only its time no earlier operation covers.  From a
profiled stretch of the program's spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "forward", "layers", "lattice", "device_ms")
