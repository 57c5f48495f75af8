"""engine_seeds_ms.predict: the host ms a traced request in the program's span
``engine.seeds``: the S × sites MC seeds hashed on the CPU inside
``BayesEngine.predict``."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "engine.seeds", "host")
