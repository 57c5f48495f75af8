"""stem_ms.predict: the card's ms a traced request in the program's device
span ``resnet.stem`` (the stem conv and its pool), timed by event nodes
inside the replayed graph."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "resnet.stem", "device")
