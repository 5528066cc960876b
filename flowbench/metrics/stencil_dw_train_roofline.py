"""stencil_dw_train_roofline: the stencil weight gradients of the profiled
steps (``flowbench.work.stencil_dw``) over the device time of the kernels
that compute them, as a share of the roofline (%)."""

from flowbench.metrics import device_trace, summed
from flowbench.work import roofline, stencil_dw

KERNELS = ("dkernel_wgmma", "dkernel_f32", "sum_slabs")


def read(rec):
    tr = device_trace(rec, "train")
    if tr is None or tr.kernel_s(KERNELS) <= 0:
        return None
    work = summed(rec, lambda log: stencil_dw(log, rec.cfg), rec.profiled_ks)
    return roofline(work, tr.kernel_s(KERNELS), rec.cfg["compute_dtype"])
