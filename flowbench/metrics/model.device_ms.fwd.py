"""model.device_ms.fwd: the card's time per pair of the forward entry in the
model, in ms: the span ``model.forward`` and the spans inside it
(``model.embed``, ``model.down<s>``, ``model.corr<s>``, ``model.up<s>``,
``model.head``), ``stencil.plans`` left out; each device operation charged
to the innermost span that launched it, counting only its time no earlier
operation covers.  From a profiled stretch of the program's spans
(``flowbench.layers``)."""

from flowbench.layers import layers, value


def span(session):
    return layers(session)


def read(rec):
    return value(rec, "forward", "layers", "model", "device_ms")
