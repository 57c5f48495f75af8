"""On the card: each cell's control (and a training cell's planted faults)
come out not correct, and the program correct, at the cell's own size, on
three seeds (``perfbench/control.py`` reads the same for the limits, over
a dozen seeds)."""

import json

import pytest

from conftest import ROOT
from perfbench import control, harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEEDS = [2 ** 31 + 901, 2 ** 31 + 902, 2 ** 31 + 903]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    c = harness.load_cell(ROOT, cell)
    out = control.readings(c, SEEDS, 1.0, list(c.driver.CONTROLS), card)
    for row in out["runs"]:
        assert harness.judge(row["program"], c.limits)[0], row
        for name in c.driver.CONTROLS:
            assert not harness.judge(row[name], c.limits)[0], (name, row)
