"""plans.idle_ms.fwd: the card's idle time per pair of the forward entry in
the stencil plans, in ms: the span ``stencil.plans``
(``models.hplflownet.stencil_plans``); each gap between device operations
charged to the innermost span open on the calling thread at its midpoint.
From a profiled stretch of the program's spans (``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "forward", "layers", "plans", "idle_ms")
