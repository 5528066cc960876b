"""device.launches.train: device kernels per step of the train entry, counted by
the profiler over the traced stretch (copies and fills left out)."""

from flowbench.metrics import device_trace


def read(rec):
    tr = device_trace(rec, "train")
    if tr is None or not tr.launches:
        return None
    return tr.launches / tr.calls
