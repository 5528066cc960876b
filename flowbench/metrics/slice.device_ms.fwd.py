"""slice.device_ms.fwd: the card's self time per request of the forward
entry in the spans named ``model.slice`` (each BCL's slice back to the
points, its bias and its cast: ``ops.bcl.BilateralConv``), in ms; each
device operation charged to the innermost span that launched it, counting
only its time no earlier operation covers.  From a profiled stretch of the
program's spans (``flowbench.layers``); None where the program has no such
span."""

from flowbench.layers import layers
from flowbench.metrics._spans import self_ms


def span(session):
    return layers(session)


def read(rec):
    return self_ms(rec, "forward", "model.slice")
