"""Timing helpers (counterpart of ``bayestpu/utils/timing.py``).

Every helper takes a zero-argument function (bind its inputs with a
closure) and the device it runs on; ``scan_time_s`` and ``scan_compare``
take a step function of a scalar carry instead.

A window is ``k`` back-to-back calls. ``measure_windows`` times it with two
CUDA events on the current stream around the calls on a card, so the time
covers the card's work and any gap in which the card waited for the host
to launch (the host-bound case shows as it is); on the CPU
``time.perf_counter`` around the same calls. The event pair fences nothing
the way a device→host fetch does on the JAX package's remote TPU, so there
is no round trip to difference away: a window's time divided by ``k`` is
the per-call time. ``fenced_window_s`` and ``blocking_latencies_s`` time on
the host clock and fence with ``torch.cuda.synchronize(device)`` (nothing
needs fencing on the CPU).

- ``measure_windows``: grows ``k`` (×4) from ``iters`` until a window
  lasts ``min_diff_s`` or ``k`` reaches ``max_iters``, then reports every
  window's per-call time (``WindowResult``; the median is the figure).
  ``pipelined_windows_s``, ``pipelined_s`` and ``pipelined_best_s`` are
  its list, median and best.
- ``paired_compare``: alternating A/B windows. Each pair times one window
  of A and then one of B, so what drifts over the run falls on both; the
  decision is the median per-pair ratio.
- ``scan_time_s``: the device time of a call with the host taken out, the
  JAX package's ``lax.fori_loop`` of k serially dependent calls. On a card
  two CUDA graphs are captured, of k and of 2k calls of ``c ← c + 1e-30 ·
  Σ sum(out)`` (``out = step_fn(c)``), each replayed once between two CUDA
  events; the per-call time is ``(T(2k) − T(k)) / k``, which cancels the
  replay's fixed cost. On the CPU the same loop runs eagerly under
  ``time.perf_counter``. ``scan_compare`` alternates two such timers per
  repeat and decides on the median per-pair ratio.

Where the graph timer differs from the JAX scan: XLA hoists loop-invariant
work (a weight's quantization, a cast) out of the loop and does not count
it; a graph replays every kernel of every call, so such work is counted in
each call (the port's int8 path quantizes its weights at every forward).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable

import torch


# the least seconds of a window of ``paired_compare``, and its pairs; the
# windows of ``measure_windows``
PAIR_MIN_WINDOW_S, PAIRS, WINDOWS = 0.05, 3, 3
# the most graph nodes (kernels, copies, memsets) that ``scan_time_s``
# captures, its k-call and 2k-call graphs together: a graph of 2k whole
# predicts at JAX's max_iters of 20,000 would hold millions
NODE_BUDGET = 1_000_000


@dataclasses.dataclass(frozen=True)
class WindowResult:
    """Per-call times of the windows, ascending, and the calls a window.

    ``rtt_fallback`` is True only from the scan timer, when every repeat's
    ``T(2k) − T(k)`` came out non-positive: the window then holds the
    whole-window mean ``T(2k) / 2k``, an upper bound (the JAX package's
    flag for its round-trip-inclusive estimate)."""

    windows: tuple[float, ...]
    k: int
    rtt_fallback: bool = False

    @property
    def median_s(self) -> float:
        return self.windows[len(self.windows) // 2]

    @property
    def best_s(self) -> float:
        return self.windows[0]


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def fenced_window_s(fn: Callable, device: torch.device, iters: int) -> float:
    """Host-clock seconds of ``iters`` back-to-back calls of ``fn``, ended
    by a synchronise of ``device``."""
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _fence(device)
    return time.perf_counter() - t0


def _window_s(fn: Callable, iters: int, device: torch.device) -> float:
    """Seconds of ``iters`` back-to-back calls of ``fn`` on ``device``."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return time.perf_counter() - t0


def _calibrate_k(fn: Callable, iters: int, min_diff_s: float,
                 max_iters: int, device: torch.device) -> tuple[int, float]:
    """The least ``iters``·4ⁿ whose window lasts ``min_diff_s`` (at most
    ``max_iters``), and that window's seconds."""
    k = max(iters, 1)
    while True:
        t = _window_s(fn, k, device)
        if t >= min_diff_s or k >= max_iters:
            return k, t
        k = min(4 * k, max_iters)


def measure_windows(fn: Callable, device: torch.device, iters: int = 50,
                    min_diff_s: float = 0.3, max_iters: int = 25600
                    ) -> WindowResult:
    """Per-call time of ``fn`` in WINDOWS windows of ``k`` calls each (the
    calibration window is the first), after one warm-up call."""
    fn()
    _fence(device)
    k, t = _calibrate_k(fn, iters, min_diff_s, max_iters, device)
    windows = [t / k] + [_window_s(fn, k, device) / k
                         for _ in range(WINDOWS - 1)]
    return WindowResult(tuple(sorted(windows)), k)


def pipelined_windows_s(fn: Callable, device: torch.device, iters: int = 50,
                        min_diff_s: float = 0.3, max_iters: int = 25600
                        ) -> list[float]:
    """``measure_windows``' per-call times, ascending."""
    return list(measure_windows(fn, device, iters, min_diff_s,
                                max_iters).windows)


def pipelined_s(fn: Callable, device: torch.device, iters: int = 50,
                min_diff_s: float = 0.3, max_iters: int = 25600) -> float:
    """The median window's per-call time: the figure to report."""
    return measure_windows(fn, device, iters, min_diff_s,
                           max_iters).median_s


def pipelined_best_s(fn: Callable, device: torch.device, iters: int = 50,
                     min_diff_s: float = 0.3, max_iters: int = 25600
                     ) -> float:
    """The best window's per-call time: optimistic; prefer
    ``pipelined_s``."""
    return measure_windows(fn, device, iters, min_diff_s,
                           max_iters).best_s


def paired_compare(fn_a: Callable, fn_b: Callable, device: torch.device,
                   iters: int = 10, labels: tuple[str, str] = ("a", "b")
                   ) -> dict:
    """Alternating windows of A and B → per-pair ratios → median.

    Each side's window size is calibrated first (not counted: at least
    PAIR_MIN_WINDOW_S); then each of PAIRS pairs runs a window of A and one
    of B back to back. Returns ``{pairs: [{<a>_s, <b>_s, ratio_a_over_b}],
    median_<a>_s, median_<b>_s, median_ratio_a_over_b, winner}``; a ratio
    below 1 means A is faster. ``median_<x>_s`` are the times of the pair
    whose ratio is the median, so the faster of them is the ``winner``."""
    la, lb = labels
    fn_a()
    fn_b()
    ka, _ = _calibrate_k(fn_a, iters, PAIR_MIN_WINDOW_S, 25600, device)
    kb, _ = _calibrate_k(fn_b, iters, PAIR_MIN_WINDOW_S, 25600, device)
    recs = []
    for _ in range(PAIRS):
        a = _window_s(fn_a, ka, device) / ka
        b = _window_s(fn_b, kb, device) / kb
        recs.append({f"{la}_s": a, f"{lb}_s": b, "ratio_a_over_b": a / b})
    med = sorted(recs, key=lambda r: r["ratio_a_over_b"])[PAIRS // 2]
    ratio = med["ratio_a_over_b"]
    return {"pairs": recs, f"median_{la}_s": med[f"{la}_s"],
            f"median_{lb}_s": med[f"{lb}_s"],
            "median_ratio_a_over_b": ratio,
            "winner": la if ratio <= 1.0 else lb}


def blocking_latencies_s(fn: Callable, device: torch.device, iters: int = 50,
                         warmup: int = 3) -> list[float]:
    """Per-call host-clock latencies (seconds), each call ended by a
    synchronise: the p50/p90 a caller who waits for every result sees."""
    for _ in range(warmup):
        fn()
        _fence(device)
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        _fence(device)
        ts.append(time.perf_counter() - t0)
    return ts


# ------------------------------------------------------------ scan timer


class HostSyncError(RuntimeError):
    """A step function read a device value on the host (``.item()``,
    ``float(...)``, ``.tolist()``, ``bool(...)``, …): such a step cannot be
    captured into a CUDA graph, and its time would be the host's."""


_HOST_READS = frozenset({torch.Tensor.item, torch.Tensor.tolist,
                         torch.Tensor.numpy, torch.Tensor.__float__,
                         torch.Tensor.__int__, torch.Tensor.__bool__,
                         torch.Tensor.__index__, torch.Tensor.__complex__})


class _Carry(torch.Tensor):
    """The carry of the first, checking call of a scan: every tensor
    computed from it is a ``_Carry`` too, and reading one on the host
    raises ``HostSyncError`` (on the CPU too, where nothing else would)."""

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        if func in _HOST_READS:
            raise HostSyncError(
                f"scan_time_s: step_fn calls Tensor.{func.__name__} on a "
                "value computed from the carry; a step must stay on the "
                "device to be captured into a CUDA graph")
        return super().__torch_function__(func, types, args, kwargs or {})


def _tensors(out: Any) -> list[torch.Tensor]:
    """Every tensor of a step's output (a tensor, or a nest of tuples,
    lists and dicts)."""
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (tuple, list)):
        return [t for v in out for t in _tensors(v)]
    return []


def _loop(step_fn: Callable, c: torch.Tensor, n: int) -> torch.Tensor:
    """``n`` serially dependent calls: the carry feeds each, and the whole
    output reduces into the next carry, so no call can be skipped."""
    for _ in range(n):
        leaves = _tensors(step_fn(c))
        if not leaves:
            raise ValueError("scan_time_s: step_fn returned no tensor")
        c = c + 1e-30 * sum(t.float().sum() for t in leaves)
    return c


class _Scan:
    """The loop of ``step_fn`` made ready at k calls: on a card two
    captured graphs (k and 2k calls), on the CPU the eager loop."""

    def __init__(self, step_fn: Callable, device: torch.device, k: int):
        self.step_fn, self.device, self.k = step_fn, device, k
        if device.type == "cuda":
            self.graphs = (self._capture(k), self._capture(2 * k))
        else:
            self.graphs = (None, None)

    def _capture(self, n: int) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        c0 = torch.zeros((), device=self.device)
        try:
            with torch.cuda.graph(graph):
                _loop(self.step_fn, c0, n)
        except RuntimeError as e:
            raise RuntimeError(
                f"scan_time_s: step_fn could not be captured into a CUDA "
                f"graph ({e}); a step may not copy to the host, "
                "synchronise or allocate pinned memory") from e
        return graph

    def _run_s(self, i: int) -> float:
        n = self.k * (1 + i)
        if self.device.type != "cuda":
            t0 = time.perf_counter()
            _loop(self.step_fn, torch.zeros(()), n)
            return time.perf_counter() - t0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(self.device)
        start.record()
        self.graphs[i].replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    def window(self) -> float:
        """One ``(T(2k) − T(k)) / k``; its negative whole-window mean
        ``−T(2k) / 2k`` when the difference is not positive."""
        t1, t2 = self._run_s(0), self._run_s(1)
        d = (t2 - t1) / self.k
        return d if d > 0 else -t2 / (2 * self.k)


def _nodes_per_call(step_fn: Callable, device: torch.device) -> int:
    """Device operations (kernels, copies, memsets) of one loop call: what
    one call adds to a captured graph, from ``torch.profiler`` over three
    calls."""
    from torch.profiler import ProfilerActivity, profile

    from bayestpu_torch.utils.profiler import device_events
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _loop(step_fn, torch.zeros((), device=device), 3)
        torch.cuda.synchronize(device)
    n = sum(e.count for e in device_events(prof))
    return max(n // 3, 1)


def _scan_prepared(step_fn: Callable, device: torch.device, iters: int,
                   min_diff_s: float, max_iters: int) -> _Scan:
    """Check the step (one call on a ``_Carry``), warm it up, and size k so
    that ``T(2k) − T(k)`` lasts about ``min_diff_s``: k is at least
    ``iters`` and at most ``max_iters`` and, on a card, NODE_BUDGET over
    three times the nodes of a call."""
    _loop(step_fn, torch.zeros((), device=device).as_subclass(_Carry), 1)
    if device.type == "cuda":
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _loop(step_fn, torch.zeros((), device=device), 2)
        torch.cuda.current_stream(device).wait_stream(side)
        max_iters = min(max_iters, max(
            NODE_BUDGET // (3 * _nodes_per_call(step_fn, device)), 1))
    iters = min(max(iters, 1), max_iters)
    scan = _Scan(step_fn, device, iters)
    first = scan.window()
    est = max(abs(first), 1e-7)
    k = min(max_iters, max(int(min_diff_s / est) + 1, iters))
    return scan if k == iters else _Scan(step_fn, device, k)


def scan_time_s(step_fn: Callable, device: torch.device, iters: int = 50,
                repeats: int = 3, min_diff_s: float = 0.2,
                max_iters: int = 20000) -> WindowResult:
    """Device time per call of ``step_fn`` with the host's dispatch taken
    out: ``repeats`` windows of ``(T(2k) − T(k)) / k`` over a loop of k
    serially dependent calls (see the module docstring; on a card a CUDA
    graph of each length, replayed once a window).

    ``step_fn``: a 0-dim f32 carry on ``device`` → a tensor or a nest of
    them. The carry MUST feed the computation (``lambda c: predict(x + c,
    seeds)``); the whole output feeds the next carry through a sum. A step
    that reads a device value on the host raises ``HostSyncError`` (the
    first call checks every value computed from the carry), and one that
    cannot be captured for another reason raises ``RuntimeError``; neither
    is timed some other way.

    k grows from ``iters`` to about ``min_diff_s`` of work a window, at
    most ``max_iters`` and, on a card, at most NODE_BUDGET / (3 · the nodes
    of one call): 1,000,000 nodes over the two graphs (the flagship
    vgg11_me predict, ~250 kernels, reaches it at k ≈ 1,300). Windows whose
    difference is not positive are dropped; if all are, the result is the
    largest whole-window mean with ``rtt_fallback`` set."""
    with torch.no_grad():
        scan = _scan_prepared(step_fn, device, iters, min_diff_s, max_iters)
        windows = [scan.window() for _ in range(max(repeats, 1))]
    valid = sorted(w for w in windows if w > 0)
    if not valid:
        return WindowResult((max(-w for w in windows),), scan.k, True)
    return WindowResult(tuple(valid), scan.k)


def scan_compare(step_a: Callable, step_b: Callable, device: torch.device,
                 iters: int = 50, repeats: int = 3, min_diff_s: float = 0.2,
                 max_iters: int = 20000,
                 labels: tuple[str, str] = ("a", "b")) -> dict:
    """A/B decision on ``scan_time_s``'s device times, the two sides'
    windows alternating (a, b, a, b, …) one pair a repeat; the decision is
    the median per-pair ratio. Returns JAX's keys: ``<a>_s``, ``<b>_s``
    (the median of each side), ``pairs`` (``<a>_s``, ``<b>_s``,
    ``ratio_a_over_b``, ``clean``), ``median_ratio_a_over_b``, ``winner``
    and ``rtt_fallback``. A pair where either side's difference was not
    positive is not clean, and votes only when no pair is."""
    la, lb = labels
    with torch.no_grad():
        sa = _scan_prepared(step_a, device, iters, min_diff_s, max_iters)
        sb = _scan_prepared(step_b, device, iters, min_diff_s, max_iters)
        recs = []
        for _ in range(max(repeats, 1)):
            wa, wb = sa.window(), sb.window()
            recs.append((abs(wa), abs(wb), wa > 0 and wb > 0))
    valid = [(a, b) for a, b, ok in recs if ok] or [(a, b)
                                                    for a, b, _ in recs]
    ratios = sorted(a / b for a, b in valid)
    med = ratios[len(ratios) // 2]
    was = sorted(a for a, _ in valid)
    wbs = sorted(b for _, b in valid)
    return {f"{la}_s": was[len(was) // 2],
            f"{lb}_s": wbs[len(wbs) // 2],
            "pairs": [{f"{la}_s": a, f"{lb}_s": b,
                       "ratio_a_over_b": a / b, "clean": ok}
                      for a, b, ok in recs],
            "median_ratio_a_over_b": med,
            "winner": la if med <= 1.0 else lb,
            "rtt_fallback": not all(ok for _, _, ok in recs)}
