"""sketch_p95_ms: the 95th percentile of the latencies of every call of
the window, call to returned numpy sketch (numpy's linear interpolation)."""

import numpy as np


def read(w):
    if not w.calls:
        return None
    return 1e3 * float(np.percentile([secs for secs, _ in w.calls], 95))
