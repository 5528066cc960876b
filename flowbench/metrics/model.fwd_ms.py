"""model.fwd_ms: the model alone on one pool pair's built pyramid, mean host
ms over a stretch of back-to-back calls ending in a synchronise."""

import torch

from flowbench.metrics import on_card, stretch_ms


def span(session):
    if session.entry != "forward" or not on_card(session):
        return None
    from hplflownet_tpu_torch.lattice.build import build_pyramid
    prog, dev = session.program, session.device
    a = torch.from_numpy(session.pool.pc1[0]).to(dev)
    b = torch.from_numpy(session.pool.pc2[0]).to(dev)
    with torch.inference_mode():
        scales = build_pyramid(prog.spec, a, b, adjoint_plans=False)

    def model():
        with torch.inference_mode():
            prog.model(a, b, scales)

    return stretch_ms(model, dev)


def read(rec):
    return rec.spans.get("model.fwd_ms")
