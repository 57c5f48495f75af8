"""device_idle_pct.predict: the share of the traced requests' window in
which nothing ran on the card (no kernel, copy or fill)."""


def read(run):
    r = run.record
    if r.kind != "predict" or r.trace is None:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
