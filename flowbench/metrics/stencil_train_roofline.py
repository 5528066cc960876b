"""stencil_train_roofline: a step's lattice stencil products and the input
gradients that are stencil products too (blur and corr_self: the same
work again over the negated taps) of the profiled steps, over the device
time of the kernels that compute them, as a share of the roofline (%).
corr_cross's input gradient (a dense product, then the tap tables' gather)
is not counted here."""

from flowbench.metrics import device_trace, summed
from flowbench.work import roofline, stencil

KERNELS = ("stencil_wgmma_kernel", "stencil_f32_kernel")


def _work(log, cfg):
    return (stencil(log, cfg, ("blur", "corr_self")).scaled(2.0)
            + stencil(log, cfg, ("corr_cross",)))


def read(rec):
    tr = device_trace(rec, "train")
    if tr is None or tr.kernel_s(KERNELS) <= 0:
        return None
    work = summed(rec, lambda log: _work(log, rec.cfg), rec.profiled_ks)
    return roofline(work, tr.kernel_s(KERNELS), rec.cfg["compute_dtype"])
