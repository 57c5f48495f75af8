"""quant_im2col_ms.predict: the card's ms a traced request in the program's
device spans ``quant.im2col`` (the int8 convs' padded input unfolded and
materialised), timed by event nodes inside the replayed graph."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "quant.im2col", "device")
