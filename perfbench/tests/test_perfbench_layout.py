"""BENCHMARK.json and the files it names: every cell resolves, every name
and unit is well formed, and a new configuration, cell and per-layer
metric run as new files and entries alone."""

import json
import re
import time

import pytest
import torch

from conftest import ROOT, SMALL, copy_root
from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"}


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_entries():
    b = bench()
    assert set(b) == TOP_KEYS
    assert b["paths"] == ["perfbench"]
    assert 1 <= b["run_seconds"] <= 51
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])


def test_names_and_units():
    b = bench()
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    c = harness.load_cell(ROOT, cell)
    assert c.limits, "each cell has the limits of its comparison"
    assert c.config["reduced"] == []
    e2e = harness.metrics_of(c, traced=False)
    layer = harness.metrics_of(c, traced=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer, "each cell reports a per-layer metric"
    for m in layer:
        assert m["moves"] in {x["name"] for x in e2e}
    for m in e2e + layer:
        assert callable(harness.reader(ROOT, m["name"]))
    specs = c.reference.param_specs(c.config)
    assert len({s[0] for s in specs}) == len(specs)


def test_a_new_config_cell_and_metric_are_files_and_entries(tmp_path):
    """A configuration (vgg11_me in f32), a traffic mix, a cell, its limits
    and a per-layer metric, added as new files and new entries only."""
    root = copy_root(tmp_path, SMALL)
    before = {p: p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "perfbench/configs/vgg11_me_bf16.json")
                     .read_text())
    cfg.update(dtype="float32", compute="float32")
    (root / "perfbench/configs/vgg11_me_f32.json").write_text(
        json.dumps(cfg))
    (root / "perfbench/traffic/predict_b2_s4.json").write_text(json.dumps(
        {"kind": "predict_closed", "batch": 2, "samples": 4, "pool": 2,
         "keep_every": 2, "check_requests": 2, "traced_requests": 2}))
    (root / "perfbench/limits/vgg11_me_f32.predict_b2_s4.json").write_text(
        json.dumps({"probs_gap": 1e-4, "var_gap": 1e-4,
                    "entropy_gap": 1e-4}))
    (root / "perfbench/metrics/requests.predict.py").write_text(
        "def read(run):\n    return float(run.record.requests)\n")
    b = json.loads((root / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "vgg11_me_f32", "source": "x",
                         "file": "perfbench/configs/vgg11_me_f32.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "vgg11_me_f32.predict_b2_s4",
                           "config": "vgg11_me_f32",
                           "traffic": "predict_b2_s4", "chips": 1,
                           "why": "x"})
    for m in b["end_to_end"]:
        if m["name"] == "mc_samples_per_s":
            m["workloads"].append("vgg11_me_f32.predict_b2_s4")
    b["per_layer"].append({"name": "requests.predict", "unit": "count",
                           "better": "higher", "source": "host_clock",
                           "layer": "engine", "moves": "mc_samples_per_s",
                           "workloads": ["vgg11_me_f32.predict_b2_s4"]})
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    for p, data in before.items():
        if p.name != "BENCHMARK.json":
            assert p.read_bytes() == data, f"{p} was edited"
    cell = harness.load_cell(root, "vgg11_me_f32.predict_b2_s4")
    line = harness.run(cell, 2 ** 31 + 5, 0.5, True, torch.device("cpu"),
                       time.perf_counter())
    assert line["correct"], line["checks"]
    assert line["metrics"]["requests.predict"]["value"] >= 1
