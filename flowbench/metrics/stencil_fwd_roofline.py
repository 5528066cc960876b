"""stencil_fwd_roofline: the forward's lattice stencil products (blur,
corr_self, corr_cross; ``flowbench.work.stencil``) of the profiled pairs
over the device time of the kernels that compute them, as a share of the
roofline (%)."""

from flowbench.metrics import device_trace, summed
from flowbench.work import roofline, stencil

KERNELS = ("stencil_wgmma_kernel", "stencil_f32_kernel")


def read(rec):
    tr = device_trace(rec, "forward")
    if tr is None or tr.kernel_s(KERNELS) <= 0:
        return None
    work = summed(rec, lambda log: stencil(log, rec.cfg), rec.profiled_ks)
    return roofline(work, tr.kernel_s(KERNELS), rec.cfg["compute_dtype"])
