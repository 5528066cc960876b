"""lattice.fill.fwd: the share of the lattice's static-shape rows that hold a
real vertex, over the forward's scales and pairs, in %: the program's
counters ``lattice.vertices`` (both clouds' ``num_valid`` per scale) over
``lattice.rows`` (2 x capacity per scale), read after a synchronise; every
kernel of the build and the model runs over all the rows
(``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "forward", "fill")
