"""heads_roofline.predict: the MC heads' samples launches in the
traced requests, their least time (``perfbench.work.head_bound_s`` at the
cell's shapes, a launch's mean over the heads) over their device time in
the profiler, in percent."""


def read(run):
    r = run.record
    if r.kind != "predict" or r.trace is None:
        return None
    w = run.work
    heads = [s for s in run.shapes if s["op"] == "head"]
    secs, count = r.trace.kernel_time(w.is_head_kernel)
    if count == 0 or secs <= 0:
        return None
    bound = sum(w.head_bound_s(h, r.batch, r.samples, run.cell.compute)
                for h in heads) / len(heads)
    return 100.0 * bound * count / secs
