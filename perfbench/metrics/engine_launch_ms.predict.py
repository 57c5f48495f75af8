"""engine_launch_ms.predict: the host ms a traced request in the program's span
``engine.launch``: x and the seeds copied into the graph's buffers and
the graph launched."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "engine.launch", "host")
