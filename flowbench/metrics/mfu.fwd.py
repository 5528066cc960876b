"""mfu.fwd: the model's operations of every pair of the window (counted
from the reference's tables: ``flowbench.work.model_flops``) over the
window's seconds times the card's bf16 dense peak, in %."""

from flowbench.metrics import on_card
from flowbench.work import PEAKS, model_flops


def read(rec):
    if rec.entry != "forward" or not rec.work or not on_card(rec):
        return None
    flops = sum(model_flops(rec.work[k]) for k in rec.window_ks)
    return 100.0 * flops / (rec.window_s * PEAKS["flops"][rec.cfg["compute_dtype"]])
