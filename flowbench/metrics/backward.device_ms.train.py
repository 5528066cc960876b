"""backward.device_ms.train: the card's time per step of the train entry in
the backward, in ms: the span ``train.backward``: ``torch.autograd.grad``,
whose kernels the autograd engine's thread launches while the calling thread
waits in it; each device operation charged to the innermost span that
launched it, counting only its time no earlier operation covers.  From a
profiled stretch of the program's spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "train", "layers", "backward", "device_ms")
