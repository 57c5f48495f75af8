"""Profiling and performance reports: traces, the cost of a call, the
roofline (counterpart of ``bayestpu/utils/profiler.py``).

- ``trace(logdir)``: ``torch.profiler`` over the ``with`` body (the CPU,
  and the card when there is one), written to ``logdir/trace.json`` in the
  Chrome trace format (``chrome://tracing``, Perfetto);
- ``cost_report(fn, *args)``: what one call costs, in the JAX report's
  keys, counted rather than taken from a compiler's cost model;
- ``measure``: the per-call time (``utils.timing.pipelined_s``);
- ``roofline``: measured time against the least time the card could take
  for the call's operations and bytes, at the peaks of ``PEAKS``.

The operations of a call are PyTorch's ``FlopCounterMode`` count of the
ATen ops it runs plus the work the port's kernel wrappers record where they
launch (``work_counts`` of ``kernels.masked_matmul`` and
``kernels.masked_conv``): the flop counter does not see a kernel launched
through ctypes, and on the CPU, where the wrappers run their plain
versions, it counts those. So a kernel's roofline reads the same
operations whatever runs it.
"""

from __future__ import annotations

import contextlib
import os
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
