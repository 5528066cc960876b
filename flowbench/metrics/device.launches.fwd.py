"""device.launches.fwd: device kernels per pair of the forward entry, counted by
the profiler over the traced stretch (copies and fills left out)."""

from flowbench.metrics import device_trace


def read(rec):
    tr = device_trace(rec, "forward")
    if tr is None or not tr.launches:
        return None
    return tr.launches / tr.calls
