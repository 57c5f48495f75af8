"""quant_inputs_ms.predict: the card's ms a traced request in the program's
device spans ``quant.inputs`` (activations put on the int8 grid), timed by
event nodes inside the replayed graph."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "quant.inputs", "device")
