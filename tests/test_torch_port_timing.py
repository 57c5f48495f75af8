"""The port's timing helpers (``bayestpu_torch/utils/timing.py``) on the
host clock, the CPU path of every helper: the card's CUDA events and graph
replays are held by ``chip_smoke.py``'s ``tools`` phase.

``scan_compare`` names the side that does twice the work, as
``tests/test_timing.py`` holds JAX's; a step that reads a device value on
the host is refused, not timed.
"""

import time

import numpy as np
import pytest
import torch

import bayestpu.utils.timing as jtiming
import bench.timing as jbench_timing
from bayestpu_torch.bench import timing as tbench_timing
from bayestpu_torch.utils import timing as T

from port_threads import thread_budget  # noqa: F401

CPU = torch.device("cpu")


def _sleep_ms(ms):
    return lambda: time.sleep(ms / 1e3)


def test_public_names_are_jaxs():
    """Every public name of the JAX timing module, and the bench's
    re-export of them, has its counterpart."""
    names = {n for n in dir(jtiming) if not n.startswith("_")
             and callable(getattr(jtiming, n))
             and getattr(getattr(jtiming, n), "__module__", "")
             == jtiming.__name__}
    assert names <= set(dir(T)), names - set(dir(T))
    jb = {n for n in dir(jbench_timing) if not n.startswith("_")}
    assert jb <= set(dir(tbench_timing)), jb - set(dir(tbench_timing))


def test_fenced_and_blocking_on_the_host_clock():
    assert T.fenced_window_s(_sleep_ms(1), CPU, 3) >= 0.003
    lat = T.blocking_latencies_s(_sleep_ms(1), CPU, iters=4, warmup=1)
    assert len(lat) == 4 and min(lat) >= 0.001


def test_pipelined_helpers_and_best_s():
    """The list, median and best of ``measure_windows``: three windows of
    the calibrated k, ascending; best ≤ median."""
    ws = T.pipelined_windows_s(_sleep_ms(1), CPU, iters=1, min_diff_s=0.01)
    assert len(ws) == 3 and ws == sorted(ws) and ws[0] >= 0.001
    med = T.pipelined_s(_sleep_ms(1), CPU, iters=1, min_diff_s=0.01)
    best = T.pipelined_best_s(_sleep_ms(1), CPU, iters=1, min_diff_s=0.01)
    assert med >= 0.001 and best >= 0.001
    res = T.WindowResult((1.0, 2.0, 3.0), 4)
    assert res.best_s == 1.0 and res.median_s == 2.0
    assert not res.rtt_fallback


def test_scan_time_s_on_the_host_clock():
    """A 128×128 matmul step: positive per-call times from windows of at
    least ``iters`` calls, the carry fed in and the output summed out."""
    a = torch.from_numpy(np.random.default_rng(0).normal(
        size=(128, 128)).astype(np.float32))
    calls = []

    def step(c):
        calls.append(1)
        return (a + c) @ a

    r = T.scan_time_s(step, CPU, iters=8, repeats=3, min_diff_s=0.0)
    assert r.k == 8 and not r.rtt_fallback
    assert 1 <= len(r.windows) <= 3 and r.median_s > 1e-8
    # the checking call, the sizing window (k + 2k) and 3 windows
    assert len(calls) == 1 + 3 * 8 + 3 * 3 * 8


def test_scan_compare_detects_2x_work():
    a = torch.from_numpy(np.random.default_rng(2).normal(
        size=(196, 196)).astype(np.float32))

    def one(c):
        return (a + c) @ a

    def two(c):
        return ((a + c) @ a) @ a

    # a concurrent test worker can perturb one pair: sizeable windows and
    # retries, so only a systematic ranking failure trips
    for attempt in range(3):
        out = T.scan_compare(one, two, CPU, iters=8, repeats=3,
                             min_diff_s=0.05, labels=("one", "two"))
        if out["winner"] == "one" or attempt == 2:
            break
    assert out["winner"] == "one"
    assert out["median_ratio_a_over_b"] < 1.0
    assert len(out["pairs"]) == 3
    assert set(out) == {"one_s", "two_s", "pairs", "median_ratio_a_over_b",
                        "winner", "rtt_fallback"}
    assert set(out["pairs"][0]) == {"one_s", "two_s", "ratio_a_over_b",
                                    "clean"}


@pytest.mark.parametrize("read", [
    lambda t: t.sum().item(), lambda t: float(t.sum()),
    lambda t: t.tolist(), lambda t: bool(t.sum() > 0),
    lambda t: int(t.sum()), lambda t: t.numpy()])
def test_a_step_that_syncs_the_host_is_refused(read):
    """Reading a value computed from the carry on the host raises
    ``HostSyncError`` before anything is timed (on a card the capture
    would fail, or time the host)."""
    a = torch.ones(4, 4)
    calls = []

    def step(c):
        calls.append(1)
        y = (a + c) @ a
        read(y)
        return y

    with pytest.raises(T.HostSyncError, match="carry"):
        T.scan_time_s(step, CPU, iters=2, min_diff_s=0.0)
    assert len(calls) == 1
    with pytest.raises(T.HostSyncError):
        T.scan_compare(lambda c: a + c, step, CPU, iters=2, min_diff_s=0.0)


def test_a_step_without_a_tensor_is_refused():
    with pytest.raises(ValueError, match="no tensor"):
        T.scan_time_s(lambda c: None, CPU, iters=2, min_diff_s=0.0)
