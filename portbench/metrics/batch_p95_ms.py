"""batch_p95_ms: 95th percentile of the host time of every call in the
window, each ending in a synchronise (linear interpolation). Reads
``batch_p95_ms.<part>``."""

import numpy as np


def read(rec):
    if not rec.calls:
        return None
    return float(np.percentile(np.asarray(rec.call_s) * 1e3, 95))
