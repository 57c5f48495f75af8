"""train_backward_ms.train: the card's ms a traced step in the program's span
``train.backward`` (the EED loss and the gradients), by its CUDA events."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "train.step", "train.backward", "device")
