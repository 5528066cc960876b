"""dense_fwd_roofline: the forward's dense layers (``flowbench.work.dense``:
real rows only) of the profiled pairs over the device time of the GEMM
kernels, as a share of the roofline at the bf16 peak (%)."""

from flowbench.metrics import device_trace, summed
from flowbench.work import dense, roofline

KERNELS = ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_", "ampere_")


def read(rec):
    tr = device_trace(rec, "forward")
    if tr is None or tr.kernel_s(KERNELS) <= 0:
        return None
    work = summed(rec, lambda log: dense(log, rec.cfg), rec.profiled_ks)
    return roofline(work, tr.kernel_s(KERNELS), rec.cfg["compute_dtype"])
