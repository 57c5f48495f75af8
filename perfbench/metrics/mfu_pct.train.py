"""mfu_pct.train: three times the forward's operations (counted from the
configuration's shapes, ``perfbench.work.train_ops``) of every step the
window ran, over the window's time, as a share of the peak of the
configuration's compute type. The traced steps are not in the window."""


def read(run):
    r = run.record
    if r.kind != "train":
        return None
    w = run.work
    ops = w.train_ops(run.shapes, r.batch) * r.steps
    return 100.0 * ops / r.window_s / w.PEAK_OPS[run.cell.compute]
