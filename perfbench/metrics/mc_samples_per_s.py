"""mc_samples_per_s: images × S of every request the window completed,
over the window's time on the host's clock."""


def read(run):
    r = run.record
    if r.kind != "predict":
        return None
    return r.requests * r.batch * r.samples / r.window_s
