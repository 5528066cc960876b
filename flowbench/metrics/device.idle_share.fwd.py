"""device.idle_share.fwd: 1 - (device busy per pair in the profiled stretch) /
(wall time per pair of the same run's unprofiled window), in %."""

from flowbench.metrics import device_trace


def read(rec):
    tr = device_trace(rec, "forward")
    if tr is None or not tr.device_ops or not rec.completed:
        return None
    return 100.0 * (1.0 - (tr.busy_s / tr.calls) / (rec.window_s / rec.completed))
