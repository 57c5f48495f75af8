"""mfu_pct.predict: the operations a spatial predictive needs (counted
from the configuration's shapes, ``perfbench.work.predict_ops``) of every
request the window completed, over the window's time, as a share of the
peak of the configuration's compute type. The traced requests are not in
the window."""


def read(run):
    r = run.record
    if r.kind != "predict":
        return None
    w = run.work
    ops = w.predict_ops(run.shapes, r.batch, r.samples) * r.requests
    return 100.0 * ops / r.window_s / w.PEAK_OPS[run.cell.compute]
