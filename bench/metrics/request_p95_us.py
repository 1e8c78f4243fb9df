"""The 95th percentile of every request's latency in the window, host clock:
the copy of ``x`` in, the program's call, the product, ``y`` back on the
host."""

import numpy as np


def read(run):
    lat = run.window.latencies_s
    return float(np.percentile(lat, 95)) * 1e6 if lat else None
