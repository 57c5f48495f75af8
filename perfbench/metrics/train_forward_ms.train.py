"""train_forward_ms.train: the card's ms a traced step in the program's span
``train.forward`` (the train-mode forward), by its CUDA events."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "train.step", "train.forward", "device")
