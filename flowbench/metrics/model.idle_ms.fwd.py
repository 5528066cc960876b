"""model.idle_ms.fwd: the card's idle time per pair of the forward entry in
the model, in ms: the span ``model.forward`` and the spans inside it
(``model.embed``, ``model.down<s>``, ``model.corr<s>``, ``model.up<s>``,
``model.head``), ``stencil.plans`` left out; each gap between device
operations charged to the innermost span open on the calling thread at its
midpoint.  From a profiled stretch of the program's spans
(``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "forward", "layers", "model", "idle_ms")
