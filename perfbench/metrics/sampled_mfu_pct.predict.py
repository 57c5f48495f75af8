"""sampled_mfu_pct.predict: the operations a spatial predictive of a
block-site model needs (``perfbench.work_blocks.sampled_ops``: the layers
before the first site once, every later layer and the head S times) of
every request the window completed, over the window's time, as a share of
the peak of the configuration's compute type."""


def read(run):
    from perfbench import work_blocks

    r = run.record
    if r.kind != "predict":
        return None
    ops = work_blocks.sampled_ops(run.shapes, r.batch, r.samples) * (
        r.requests)
    return 100.0 * ops / r.window_s / run.work.PEAK_OPS[run.cell.compute]
