"""The run's contract that a CPU can check: what it imports, the keys of
its last line, and refusing to run without a card or outside a
checkout."""

import ast
import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SMALL, copy_root

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "bayestpu"}
CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


def top_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    """A whole CPU run of every cell in one process, then the top-level
    names of every loaded module (``bayestpu_torch`` is a name of its
    own)."""
    copy_root(tmp_path, SMALL)
    names = top_names(f"""
import json, sys, time, torch
from pathlib import Path
sys.path.insert(0, {str(ROOT)!r})
from perfbench import harness
for cell in {CELLS!r}:
    c = harness.load_cell(Path({str(tmp_path)!r}), cell)
    harness.run(c, 3, 0.2, False, torch.device("cpu"), time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert "bayestpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    names = top_names(f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import perfbench.reference.common, perfbench.reference.vgg_me
import perfbench.reference.resnet_me, perfbench.reference.training
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
""")
    assert not names & (FORBIDDEN | {"bayestpu_torch"})
    for f in (ROOT / "perfbench/reference").glob("*.py"):
        for node in ast.walk(ast.parse(f.read_text())):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module] if isinstance(node, ast.ImportFrom) else [])
            for m in mods:
                assert m.split(".")[0] not in FORBIDDEN | {"bayestpu_torch"}


@pytest.mark.parametrize("traced", [False, True])
def test_last_line_keys(tmp_path, traced):
    import time

    import torch

    from perfbench import harness

    copy_root(tmp_path, SMALL)
    cell = harness.load_cell(tmp_path, "vgg11_me_bf16.predict_b128")
    line = harness.run(cell, 2 ** 31 + 1, 0.3, traced, torch.device("cpu"),
                       time.perf_counter())
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line) == keys + (["breakdown"] if traced else []) + [
        "checks"]
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in harness.metrics_of(cell, traced)}
    assert set(line["metrics"]) <= names
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_refuses_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench")
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
