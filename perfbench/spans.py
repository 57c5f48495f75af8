"""The program's own spans in a traced run, for the per-layer readers.

``bayestpu_torch.utils.profiler`` keeps a log of the spans that ran while
a profiler was active, in memory, each with its root: one ``engine.
predict`` a request, one ``train.step`` a step. The traced units are the
last requests or steps of a ``--trace 1`` run's tail, so a reader takes
the last ``trace.units`` roots of the log and averages over them. A
program without spans (no ``span_log``) gives nothing to read.
"""

from __future__ import annotations


def _log():
    from bayestpu_torch.utils import profiler

    read = getattr(profiler, "span_log", None)
    return read() if read is not None else None


def per_root(run, root: str, name: str, clock: str) -> float | None:
    """The mean over the traced units of the ms that the spans ``name``
    took in each (summed within a unit), on the ``clock`` "host" or
    "device"; the root's own time where ``name`` is ``root``. None for an
    untraced run, a log without such roots or spans, or a span without
    that clock."""
    r = run.record
    if r.trace is None or not r.trace.units:
        return None
    log = _log()
    if not log:
        return None
    roots = [s.id for s in log if s.name == root and s.parent is None]
    roots = set(roots[-r.trace.units:])
    if not roots:
        return None
    field = "host_ms" if clock == "host" else "device_ms"
    per: dict[int, float] = {}
    for s in log:
        if s.root in roots and s.name == name:
            ms = getattr(s, field)
            if ms is None:
                return None
            per[s.root] = per.get(s.root, 0.0) + ms
    if not per:
        return None
    return sum(per.values()) / len(roots)
