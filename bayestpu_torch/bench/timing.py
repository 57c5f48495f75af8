"""Re-export of the timing helpers (counterpart of ``bench/timing.py``; the
implementation lives in ``bayestpu_torch.utils.timing``)."""

from bayestpu_torch.utils.timing import (  # noqa: F401
    WindowResult,
    blocking_latencies_s,
    fenced_window_s,
    measure_windows,
    paired_compare,
    pipelined_best_s,
    pipelined_s,
    pipelined_windows_s,
    scan_compare,
    scan_time_s,
)
