"""train_update_ms.train: the card's ms a traced step in the program's span
``train.update`` (the clip, the optimizer and the update), by its CUDA
events."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "train.step", "train.update", "device")
