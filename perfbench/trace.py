"""The traced sub-window: ``torch.profiler`` over the last requests or
steps of a ``--trace 1`` run, reduced to what the per-layer readers take.

The harness names what the host is doing with ``record_function`` spans of
its own around each call into the program (``predict``, ``readback``,
``seeds``, ``step``, ``sync``) and one ``unit`` span around each request or
step. The window is from the first unit's start to the last unit's end;
device activity (kernels, copies, fills) is clipped to it. Busy time is
the union of that activity; an idle gap is named by the innermost harness
span the host was in at its middle ("host" where it was in none).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

SPANS = ("predict", "readback", "seeds", "step", "sync")
UNIT = "unit"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160


@dataclass
class Trace:
    """The traced window, in seconds on the host's clock."""

    window_s: float
    busy_s: float
    units: int
    kernels: list = field(default_factory=list)   # (name, start_s, dur_s)
    gaps: list = field(default_factory=list)      # (span, dur_s)

    def kernel_time(self, select) -> tuple[float, int]:
        """Total device seconds and count of the kernels ``select``
        (a predicate on the name) keeps."""
        durs = [d for name, _, d in self.kernels if select(name)]
        return sum(durs), len(durs)

    def device_ops(self, top: int = 10) -> list:
        """The kernels that took most device time, by name (its first
        NAME_CHARS characters)."""
        tot: dict[str, float] = {}
        for name, _, d in self.kernels:
            tot[name] = tot.get(name, 0.0) + d
        return [[n[:NAME_CHARS], s] for n, s in
                sorted(tot.items(), key=lambda kv: -kv[1])][:top]

    def idle_gaps(self, top: int = 10) -> list:
        return [[n, s] for n, s in sorted(self.gaps, key=lambda g: -g[1])
                ][:top]


def span(name: str):
    """A harness span, for the traced part of a run."""
    return torch.profiler.record_function(name)


def no_span(name: str):
    """No span: the untraced part of a run pays for none."""
    return contextlib.nullcontext()


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list) -> Trace:
    """A chrome trace's events → ``Trace``."""
    units, spans, dev = [], [], []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t0, t1 = e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6
        if cat == "user_annotation":
            if name == UNIT:
                units.append((t0, t1))
            elif name in SPANS:
                spans.append((t0, t1, name))
        elif cat in DEVICE_CATS:
            dev.append((t0, t1, name, cat))
    if not units:
        raise RuntimeError("the trace holds no harness unit span")
    w0, w1 = min(u[0] for u in units), max(u[1] for u in units)
    kernels, busy_iv = [], []
    for t0, t1, name, cat in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b <= a:
            continue
        busy_iv.append((a, b))
        if cat == "kernel":
            kernels.append((name, t0, t1 - t0))
    busy = _union(busy_iv)
    gaps, prev = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > prev:
            mid = 0.5 * (prev + a)
            inside = [s for s in spans if s[0] <= mid <= s[1]]
            label = (min(inside, key=lambda s: s[1] - s[0])[2] if inside
                     else "host")
            gaps.append((label, a - prev))
        prev = max(prev, b)
    return Trace(window_s=w1 - w0, busy_s=sum(b - a for a, b in busy),
                 units=len(units), kernels=kernels, gaps=gaps)


def profiled(fn) -> Trace:
    """Run ``fn`` under the profiler (CPU and CUDA activity) and reduce
    its trace. The trace file goes to a temporary directory (under
    ``TMPDIR``) that is removed at once."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    with tempfile.TemporaryDirectory(prefix="perfbench-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return reduce_events(events)
