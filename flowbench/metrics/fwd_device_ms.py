"""fwd_device_ms: the card's busy time per pair of the forward entry, in
ms: the union of the device operations' intervals (kernels, copies, fills)
over the profiled stretch that follows the window, over its pairs."""

from flowbench.metrics import device_trace


def read(rec):
    tr = device_trace(rec, "forward")
    if tr is None or not tr.device_ops:
        return None
    return 1e3 * tr.busy_s / tr.calls
