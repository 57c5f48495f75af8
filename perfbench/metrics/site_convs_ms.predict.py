"""site_convs_ms.predict: the card's ms a traced request in the program's
device spans ``sites.conv`` (each deferred block site's two masked convs),
timed by event nodes inside the replayed graph."""

from perfbench.spans import per_root


def read(run):
    return per_root(run, "engine.predict", "sites.conv", "device")
