"""fwd_p95_ms: the 95th percentile of every request of the window, each
timed on the host clock from handing in its host arrays to its flow being
a host array."""

import numpy as np


def read(rec):
    if rec.entry != "forward" or not rec.latencies_ms:
        return None
    return float(np.percentile(np.asarray(rec.latencies_ms), 95))
