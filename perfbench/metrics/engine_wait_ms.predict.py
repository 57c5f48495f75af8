"""engine_wait_ms.predict: the card's ms a traced request from the entry event
of the program's ``engine.predict`` to its event just before the launch:
in the closed loop the stream is empty at the call, so this is how long the
card waited on the host inside ``predict``."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "engine.predict", "device")
