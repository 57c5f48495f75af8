"""train_images_per_s: images of every training step the window ran, over
the window's time, which ends when the card has finished them (host
clock)."""


def read(run):
    r = run.record
    if r.kind != "train":
        return None
    return r.steps * r.batch / r.window_s
