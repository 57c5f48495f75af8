"""site_window_ms.predict: the card's ms a traced request in the program's
device spans ``sites.window_conv`` (each deferred block site's masked
``convbn1`` wider than 1×1, inside ``sites.conv``), timed by event nodes
inside the replayed graph."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "sites.window_conv", "device")
