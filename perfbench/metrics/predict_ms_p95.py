"""predict_ms_p95: the 95th percentile of the latency of every request of
the window, from the call to ``predict`` until its mean, variance and
entropy are on the host (host clock)."""

import numpy as np


def read(run):
    r = run.record
    if r.kind != "predict" or not r.latencies_s:
        return None
    return float(np.percentile(np.asarray(r.latencies_s), 95.0)) * 1e3
