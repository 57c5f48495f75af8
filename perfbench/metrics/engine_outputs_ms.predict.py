"""engine_outputs_ms.predict: the host ms a traced request in the program's span
``engine.outputs``: the three clones of the graph's outputs."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "engine.outputs", "host")
