"""adam.idle_ms.train: the card's idle time per step of the train entry in
Adam, in ms: the span ``train.adam``: the update and the overflow select;
each gap between device operations charged to the innermost span open on the
calling thread at its midpoint.  From a profiled stretch of the program's
spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "train", "layers", "adam", "idle_ms")
