"""The timing helpers of the engine (counterpart of the part of
``bayestpu/utils/timing.py`` that ``BayesEngine.benchmark`` and
``autotune`` call).

A window is ``k`` back-to-back calls of a zero-argument function. On a
card it is timed by two CUDA events on the current stream around the
calls, so the time covers the card's work and any gap in which the card
waited for the host to launch (the host-bound case shows as it is); on
the CPU by ``time.perf_counter`` around the same calls. The event pair
fences nothing the way a device→host fetch does on the JAX package's
remote TPU, so there is no round trip to difference away: a window's time
divided by ``k`` is the per-call time.

- ``measure_windows``: grows ``k`` (×4) from ``iters`` until a window
  lasts ``min_diff_s`` or ``k`` reaches ``max_iters``, then reports every
  window's per-call time (``WindowResult``; the median is the figure).
  There is no round trip, so no ``rtt_fallback`` either.
- ``paired_compare``: the alternating A/B contract of JAX's
  ``paired_compare``/``scan_compare``. Each pair times one window of A
  and then one of B, so what drifts over the run falls on both; the
  decision is the median per-pair ratio. ``scan_compare`` itself is a TPU
  device scan and has no counterpart.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch


# the least seconds of a window of ``paired_compare``, and its pairs; the
# windows of ``measure_windows``
PAIR_MIN_WINDOW_S, PAIRS, WINDOWS = 0.05, 3, 3


@dataclasses.dataclass(frozen=True)
class WindowResult:
    """Per-call times of the windows, ascending, and the calls a window."""

    windows: tuple[float, ...]
    k: int

    @property
    def median_s(self) -> float:
        return self.windows[len(self.windows) // 2]


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
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    k, t = _calibrate_k(fn, iters, min_diff_s, max_iters, device)
    windows = [t / k] + [_window_s(fn, k, device) / k
                         for _ in range(WINDOWS - 1)]
    return WindowResult(tuple(sorted(windows)), k)


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
