"""adam.device_ms.train: the card's time per step of the train entry in
Adam, in ms: the span ``train.adam``: the update and the overflow select;
each device operation charged to the innermost span that launched it,
counting only its time no earlier operation covers.  From a profiled stretch
of the program's spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "train", "layers", "adam", "device_ms")
