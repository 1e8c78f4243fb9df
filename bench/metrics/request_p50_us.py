"""The median of the same requests' latencies as ``request_p95_us``."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 50)) * 1e6 if lat else None
