"""train_device_ms: the card's busy time per training step, in ms: the
union of the device operations' intervals (kernels, copies, fills) over the
profiled stretch that follows the window, over its steps."""

from flowbench.metrics import device_trace


def read(rec):
    tr = device_trace(rec, "train")
    if tr is None or not tr.device_ops:
        return None
    return 1e3 * tr.busy_s / tr.calls
