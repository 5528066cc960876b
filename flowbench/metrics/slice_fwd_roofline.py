"""slice_fwd_roofline: the slices of the layers' profiled requests over the
card's self time in the spans named ``model.slice``, as a share of the
roofline at the bf16 peak (%).

The work is the reference log's ``slice`` entries (:func:`slice_work`):
``2 C`` operations per present (point, vertex) pair, as ``flowbench.work``
counts splat and slice; bytes: the vertices' C features read once in the
compute dtype (the vertex count is that of the splat before it in the log,
the same cloud and scale), each present pair's vertex id and barycentric
weight at 4 bytes each, and the (points, C) result written once in the
accumulation dtype.  None where the program has no such span."""

from flowbench.layers import layers
from flowbench.metrics._spans import profiled_items, self_ms
from flowbench.work import ZERO, Work, _sizes, roofline


def slice_work(log, cfg) -> Work:
    b_in, b_out = _sizes(cfg)
    w, vertices = ZERO, 0
    for e in log:
        if e["kind"] == "splat":
            vertices = e["rows"]
        elif e["kind"] == "slice":
            w = w + Work(2.0 * e["entries"] * e["c"],
                         b_in * vertices * e["c"] + 8 * e["entries"]
                         + b_out * e["rows"] * e["c"])
    return w


def span(session):
    return layers(session)


def read(rec):
    ms = self_ms(rec, "forward", "model.slice")
    if not ms:
        return None
    items = profiled_items(rec)
    work = ZERO
    for k in items:
        work = work + slice_work(rec.work.get(k) or rec.session.work(k), rec.cfg)
    return roofline(work, ms * 1e-3 * len(items), rec.cfg["compute_dtype"])
