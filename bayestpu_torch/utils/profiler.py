"""Profiling and performance reports: traces, the cost of a call, the
roofline (counterpart of ``bayestpu/utils/profiler.py``).

- ``trace(logdir)``: ``torch.profiler`` over the ``with`` body (the CPU,
  and the card when there is one), written to ``logdir/trace.json`` in the
  Chrome trace format (``chrome://tracing``, Perfetto);
- ``cost_report(fn, *args)``: what one call costs, in the JAX report's
  keys, counted rather than taken from a compiler's cost model;
- ``measure``: the per-call time (``utils.timing.pipelined_s``);
- ``roofline``: measured time against the least time the card could take
  for the call's operations and bytes, at the peaks of ``PEAKS``;
- ``span(name, device=False)`` and ``count(name, n=1)``: the program's own
  spans and counters, read back with ``span_log()`` and ``counters()``.

The operations of a call are PyTorch's ``FlopCounterMode`` count of the
ATen ops it runs plus the work the port's kernel wrappers record where they
launch (``work_counts`` of ``kernels.masked_matmul`` and
``kernels.masked_conv``): the flop counter does not see a kernel launched
through ctypes, and on the CPU, where the wrappers run their plain
versions, it counts those. So a kernel's roofline reads the same
operations whatever runs it.

Spans record only while a ``torch.profiler`` is active in the process
(``trace`` among others); otherwise ``span`` costs one check and returns
the shared ``NO_SPAN``. A recorded span opens ``record_function(name)``,
so it lands in the exported trace on the profiler's clock with the
kernels it launched eagerly, and appends a ``SpanRecord`` to a bounded
log: its parent, its root (one a request or a training step) and the
host's clock at entry and exit. ``device=True`` adds a timing event on the
current CUDA stream at entry and at exit (or at ``stop_clock()``), whose
difference ``span_log()`` resolves. A device span entered while a stream
is captured into a CUDA graph under ``graph_spans`` records its events as
graph nodes: each replay of the graph yields one record a captured span
(``GraphSpans``). Counters are plain integers and always count.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import threading
import time
from typing import Any, Callable

import torch

from bayestpu_torch.utils.timing import _tensors

# Peak rates per chip and type (operations/s) and the memory rate (bytes/s).
# h100: NVIDIA's data sheet for the H100 SXM at its 700 W limit, dense:
# 989 TFLOP/s bf16, 1,979 TOP/s int8 and 495 TFLOP/s tf32 on the tensor
# cores, 67 TFLOP/s f32 outside them, 3.35 TB/s of HBM3.
# cpu: nominal, so the CPU tests have a row to divide by; no measurement.
PEAKS = {
    "h100": {"bf16": 989e12, "int8": 1979e12, "tf32": 495e12,
             "f32": 67e12, "hbm": 3.35e12},
    "cpu": {"bf16": 1e11, "int8": 2e11, "tf32": 1e11, "f32": 1e11,
            "hbm": 1e10},
}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the ``with`` body and write ``logdir/trace.json``; yields
    ``logdir``."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_events(prof) -> list:
    """The device rows of a ``torch.profiler`` run's ``key_averages()``:
    kernels, copies and memsets. Left out are the device ranges of
    ``record_function`` annotations (every recorded ``span`` opens one),
    which span the gaps between their kernels as well."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)]


def kernel_work() -> int:
    """The operations the port's kernels have recorded since their counts
    were last reset."""
    from bayestpu_torch.kernels import masked_conv, masked_matmul
    return (sum(masked_matmul.work_counts.values())
            + sum(masked_conv.work_counts.values()))


def counted_call(fn: Callable, *args: Any) -> tuple[Any, int]:
    """``fn(*args)`` and the operations it did: the flop counter's ATen
    ops plus the port's kernels' work."""
    from torch.utils.flop_counter import FlopCounterMode
    before = kernel_work()
    with FlopCounterMode(display=False) as counter:
        out = fn(*args)
    return out, counter.get_total_flops() + kernel_work() - before


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def host_peak_bytes(fn: Callable, *args: Any) -> tuple[Any, int]:
    """``fn(*args)`` on the CPU and the most bytes of storage that its ATen
    ops allocated and that were alive at once: each op's outputs that do
    not share an argument's storage count from their creation until the
    last tensor on that storage is freed. The CPU's counterpart of the
    card's ``max_memory_allocated`` above what was allocated before the
    call."""
    import weakref

    from torch.utils._python_dispatch import TorchDispatchMode

    live: dict[int, list[int]] = {}       # storage address → [refs, bytes]
    cur = peak = 0

    def drop(key: int) -> None:
        nonlocal cur
        rec = live.get(key)
        if rec is not None:
            rec[0] -= 1
            if rec[0] == 0:
                cur -= rec[1]
                del live[key]

    class Live(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            nonlocal cur, peak
            out = func(*args, **(kwargs or {}))
            inputs = {t.untyped_storage().data_ptr()
                      for t in _tensors([list(args), kwargs or {}])}
            for t in _tensors(out):
                st = t.untyped_storage()
                key = st.data_ptr()
                if key == 0 or (key in inputs and key not in live):
                    continue
                if key in live:
                    live[key][0] += 1
                else:
                    live[key] = [1, st.nbytes()]
                    cur += st.nbytes()
                    peak = max(peak, cur)
                weakref.finalize(t, drop, key)
            return out

    with Live():
        out = fn(*args)
    return out, peak


def _device(args: tuple) -> torch.device:
    ts = _tensors(list(args))
    return ts[0].device if ts else torch.device("cpu")


def cost_report(fn: Callable, *args: Any) -> dict:
    """What one call of ``fn(*args)`` costs: ``flops`` (see the module
    docstring), ``bytes_accessed`` (every tensor argument read once and
    every output written once: the bytes of a roofline's bound),
    ``argument_bytes``, ``output_bytes``, ``temp_bytes`` (the peak a
    second call allocates, less its outputs: ``temp_bytes``) and
    ``transcendentals`` (None: nothing counts them)."""
    out, flops = counted_call(fn, *args)
    arg_b, out_b = nbytes(_tensors(list(args))), nbytes(_tensors(out))
    del out
    return {"flops": flops, "bytes_accessed": arg_b + out_b,
            "transcendentals": None,
            "temp_bytes": temp_bytes(fn, *args) - out_b,
            "output_bytes": out_b, "argument_bytes": arg_b}


def temp_bytes(fn: Callable, *args: Any) -> int:
    """The peak bytes one call of ``fn(*args)`` allocates, outputs
    included: on a card ``max_memory_allocated`` above what was allocated
    before the call, on the CPU ``host_peak_bytes``."""
    dev = _device(args)
    if dev.type != "cuda":
        return host_peak_bytes(fn, *args)[1]
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    fn(*args)
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev) - base


def measure(fn: Callable, *args: Any, iters: int = 20,
            min_diff_s: float = 0.3, max_iters: int = 25600) -> float:
    """Per-call seconds of ``fn(*args)`` on the device of its tensors
    (``utils.timing.pipelined_s``: CUDA-event windows on a card)."""
    from bayestpu_torch.utils.timing import pipelined_s
    return pipelined_s(lambda: fn(*args), _device(args), iters, min_diff_s,
                       max_iters)


def chip_generation(device: str | torch.device = "cuda") -> str:
    """The ``PEAKS`` row of ``device``: ``"cpu"``, or the card's from its
    name (``torch.cuda.get_device_name``). A card without a row raises, as
    does asking for a card without one."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    name = torch.cuda.get_device_name(dev)
    for gen in PEAKS:
        if gen in name.lower():
            return gen
    raise ValueError(f"no peak rates for {name!r}; have {sorted(PEAKS)}")


def roofline(fn: Callable, *args: Any, iters: int = 20,
             gen: str | None = None, seconds: float | None = None,
             mxu_dtype: str = "bf16") -> dict:
    """Measured time against the least time for ``fn(*args)``'s work:
    ``speed_of_light_s`` is the operations (``cost_report``'s ``flops``)
    over the peak of ``mxu_dtype`` or the bytes over the memory rate,
    whichever the arithmetic intensity says bounds it; ``seconds`` gives a
    time measured elsewhere instead of ``measure``. The keys are the JAX
    report's; ``chip`` is the ``PEAKS`` row (``chip_generation`` of the
    arguments' device by default)."""
    gen = gen or chip_generation(_device(args))
    peak_flops = PEAKS[gen][mxu_dtype]
    peak_bw = PEAKS[gen]["hbm"]
    rep = cost_report(fn, *args)
    dt = seconds if seconds is not None else measure(fn, *args, iters=iters)
    flops = rep["flops"] or 0.0
    bytes_ = rep["bytes_accessed"] or 0.0
    intensity = flops / bytes_ if bytes_ else float("inf")
    bound = "compute" if intensity >= peak_flops / peak_bw else "memory"
    sol = (flops / peak_flops) if bound == "compute" else (bytes_ / peak_bw)
    out = {
        "chip": gen,
        "mxu_dtype": mxu_dtype,
        "seconds": dt,
        "achieved_tflops": flops / dt / 1e12 if flops else 0.0,
        "achieved_gbps": bytes_ / dt / 1e9 if bytes_ else 0.0,
        "arithmetic_intensity": intensity,
        "bound": bound,
        "speed_of_light_s": sol,
        "fraction_of_peak": sol / dt if dt else 0.0,
        "flops_fraction_of_peak": flops / dt / peak_flops if dt else 0.0,
    }
    if out["fraction_of_peak"] > 1.0 or out["flops_fraction_of_peak"] > 1.0:
        out["note"] = ("fraction > 1: the call ran faster than the peak of "
                       "mxu_dtype allows (a faster type than mxu_dtype, or "
                       "data served from cache rather than memory)")
    return out


# ------------------------------------------------------------------ spans

# the records the log keeps; the oldest go first
LOG_SPANS = 1 << 16


@dataclasses.dataclass
class SpanRecord:
    """One span as it ran. ``parent`` is the id of the span it ran inside
    (None for a root), ``root`` its root's id; ``start_ns`` and ``end_ns``
    are the host's ``perf_counter_ns`` at entry and exit (None for a span
    replayed inside a CUDA graph); ``device_ms`` is the card's time between
    the span's two events (None for a host span, or on the CPU)."""

    name: str
    id: int
    parent: int | None
    root: int
    start_ns: int | None
    end_ns: int | None
    device_ms: float | None = None
    # the (start, stop) events of a device span not yet resolved
    events: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float | None:
        if self.start_ns is None:
            return None
        return (self.end_ns - self.start_ns) / 1e6


_recording = torch.autograd._profiler_enabled
_log: collections.deque = collections.deque(maxlen=LOG_SPANS)
_counters: collections.Counter = collections.Counter()
_ids = itertools.count(1)
_local = threading.local()
_unsettled: set = set()        # ``GraphSpans`` replayed and not yet read


def _open_spans() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _event(external: bool) -> torch.cuda.Event:
    ev = torch.cuda.Event(enable_timing=True, external=external)
    ev.record()
    return ev


class _NoSpan:
    """What ``span`` returns while nothing records."""

    def __enter__(self) -> "_NoSpan":
        return self

    def __exit__(self, *exc) -> None:
        return None

    def stop_clock(self) -> None:
        return None


NO_SPAN = _NoSpan()


class _Span:
    """A recorded span (see the module docstring)."""

    def __init__(self, name: str, device: bool):
        self.name, self.device = name, device

    def __enter__(self) -> "_Span":
        stack = _open_spans()
        up = stack[-1] if stack else None
        if up is None:
            # read earlier roots' graph replays before this root's clocks
            # start, so that its spans do not hold that work
            for spans in list(_unsettled):
                spans.settle()
        self.id = next(_ids)
        self.parent = up.id if up is not None else None
        self.root = up.root if up is not None else self.id
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        self.start = self.stop = self.graph = None
        if self.device and torch.cuda.is_available():
            if torch.cuda.is_current_stream_capturing():
                # events become graph nodes only for a ``graph_spans``
                self.graph = getattr(_local, "graph", None)
                if self.graph is not None:
                    self.start = _event(True)
            else:
                self.start = _event(False)
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def stop_clock(self) -> None:
        """Stop the span's device clock here rather than at its exit."""
        if self.start is not None and self.stop is None:
            self.stop = _event(self.graph is not None)

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter_ns()
        self.stop_clock()
        _open_spans().pop()
        self._rf.__exit__(*exc)
        if self.graph is not None:
            self.graph.spans.append(self)
        else:
            _log.append(SpanRecord(
                self.name, self.id, self.parent, self.root, self.t0, t1,
                events=None if self.start is None else (self.start,
                                                        self.stop)))


def span(name: str, device: bool = False):
    """A span named ``name`` around the ``with`` body; ``device`` times it
    on the card as well (pass whether the work is on a card)."""
    if not _recording():
        return NO_SPAN
    return _Span(name, device)


class GraphSpans:
    """The device spans captured into one CUDA graph (``graph_spans``).
    Their events are graph nodes, which every replay records again: call
    ``replayed(up)`` after a replay, with ``up`` the span open at it (the
    parent of the captured spans that had none in the graph); ``settle``
    reads that replay's times into the log, and runs when the next root
    span opens, before any next replay of the graph, or in ``span_log``."""

    def __init__(self):
        self.spans: list[_Span] = []     # in the order they exited
        self._pending: tuple | None = None

    def replayed(self, up: _Span) -> None:
        if self.spans:
            self._pending = (up.id, up.root)
            _unsettled.add(self)

    def settle(self) -> None:
        if self._pending is None:
            return
        parent, root = self._pending
        self._pending = None
        _unsettled.discard(self)
        # the last span to exit holds the last event the graph records
        self.spans[-1].stop.synchronize()
        ids = {sp.id: next(_ids) for sp in self.spans}
        for sp in self.spans:
            _log.append(SpanRecord(sp.name, ids[sp.id],
                                   ids.get(sp.parent, parent), root, None,
                                   None, sp.start.elapsed_time(sp.stop)))


@contextlib.contextmanager
def graph_spans():
    """Collect the device spans entered while the ``with`` body captures a
    CUDA graph; yields their ``GraphSpans``."""
    spans = GraphSpans()
    prev = getattr(_local, "graph", None)
    _local.graph = spans
    try:
        yield spans
    finally:
        _local.graph = prev


def count(name: str, n: int = 1) -> None:
    _counters[name] += n


def counters() -> dict[str, int]:
    return dict(_counters)


def span_log() -> list[SpanRecord]:
    """The recorded spans, oldest first, with their device times resolved
    (which waits for the card to reach the last event)."""
    for spans in list(_unsettled):
        spans.settle()
    for rec in _log:
        if rec.events is not None:
            start, stop = rec.events
            stop.synchronize()
            rec.device_ms = start.elapsed_time(stop)
            rec.events = None
    return list(_log)


def reset_spans() -> None:
    """Empty the span log and zero the counters."""
    for spans in list(_unsettled):
        spans._pending = None
    _unsettled.clear()
    _log.clear()
    _counters.clear()
