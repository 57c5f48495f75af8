"""One run of one cell: find its files by name, set it up, measure the
window, judge what the window produced, read the metrics, print the line.

Everything that belongs to one cell is found by a name in
``BENCHMARK.json``:

- the configuration's file (``configs[].file``), which names its plain
  reference (``perfbench/reference/<reference>.py``);
- the traffic mix ``perfbench/traffic/<traffic>.json``, whose ``kind``
  names the generator that drives it (``perfbench/drivers/<kind>.py``);
- the limits of the comparison, ``perfbench/limits/<cell>.json``;
- each metric's reader, ``perfbench/metrics/<metric>.py``, a function
  ``read(run)`` that returns a number or None (nothing to read: the
  metric is left out of the line).

A driver has ``setup(cell, seed, device)``, ``window(state, seconds,
traced)``, ``release(state)`` and ``check(state, record, control)``: the
program's state is released (and the peak memory read) before the
reference runs.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from perfbench import work

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "bayestpu")


@dataclasses.dataclass
class Cell:
    name: str
    root: Path
    entry: dict          # the workload's entry in BENCHMARK.json
    config: dict         # the configuration's file
    traffic: dict
    limits: dict
    reference: ModuleType
    driver: ModuleType
    bench: dict

    @property
    def compute(self) -> str:
        return self.config["compute"]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: Path, name: str) -> Cell:
    bench = _json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(root / conf["file"])
    traffic = _json(root / "perfbench" / "traffic" /
                    f"{entry['traffic']}.json")
    limits_path = root / "perfbench" / "limits" / f"{name}.json"
    limits = _json(limits_path) if limits_path.exists() else {}
    return Cell(name, root, entry, config, traffic, limits,
                importlib.import_module(
                    f"perfbench.reference.{config['reference']}"),
                importlib.import_module(
                    f"perfbench.drivers.{traffic['kind']}"), bench)


def metrics_of(cell: Cell, traced: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``traced`` its per-layer
    ones: those that list the cell, or that list none and move a metric
    the cell reports."""
    e2e = [m for m in cell.bench["end_to_end"]
           if cell.name in m.get("workloads", [cell.name])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name])
            and ("workloads" in m or m["moves"] in names)]


def reader(root: Path, name: str):
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """Each compared number beside its limit; correct iff every number is
    within its limit (a number with no limit fails)."""
    checks, ok = {}, True
    for k, v in numbers.items():
        lim = limits.get(k)
        checks[k] = {"value": v, "limit": lim}
        ok &= lim is not None and v == v and v <= lim
    return ok, checks


def device_info(device: torch.device, count: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu",
                "kind": torch.cuda.get_device_name(device),
                "count": count,
                "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": 0}


def run(cell: Cell, seed: int, seconds: float, traced: bool,
        device: torch.device, t0: float) -> dict:
    """One run of ``cell``, set-up timed from ``t0`` (the process's start);
    returns the result line as a dict (``checks`` last)."""
    state = cell.driver.setup(cell, seed, device)
    setup_s = time.perf_counter() - t0
    gc.collect()
    gc.disable()        # no collector pauses inside the window
    try:
        record = cell.driver.window(state, seconds, traced)
    finally:
        gc.enable()
    dev = device_info(device, cell.entry["chips"])
    cell.driver.release(state)
    numbers = cell.driver.check(state, record)
    ok, checks = judge(numbers, cell.limits)
    ctx = SimpleNamespace(cell=cell, record=record, setup_s=setup_s,
                          work=work, shapes=cell.reference.layer_shapes(
                              cell.config))
    metrics = {}
    for m in metrics_of(cell, traced):
        value = reader(cell.root, m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": bool(ok and record.failed == 0
                            and record.attempted > 0),
            "attempted": record.attempted, "failed": record.failed,
            "metrics": metrics, "device": dev}
    if traced and record.trace is not None:
        dev["busy_s"] = record.trace.busy_s
        dev["window_s"] = record.trace.window_s
        line["breakdown"] = {"device_ops": record.trace.device_ops(),
                             "idle_gaps": record.trace.idle_gaps()}
    line["checks"] = checks
    return line


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (whole names: ``bayestpu_torch`` is not ``bayestpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
