"""Fixtures of the benchmark's own tests (run with ``python -m pytest
perfbench/tests -q`` from the repository's root).

Tests marked ``card`` need a CUDA card; each decides inside the test, through
the ``card`` fixture, and skips without one.
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def copy_root(dest: Path, traffic: dict | None = None,
              configs: dict | None = None) -> Path:
    """A copy of BENCHMARK.json and perfbench/ under ``dest``, each traffic
    file updated with ``traffic`` and each configuration with
    ``configs``."""
    shutil.copy(ROOT / "BENCHMARK.json", dest)
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for kind, upd in ((("traffic", traffic), ("configs", configs))):
        for f in (dest / "perfbench" / kind).glob("*.json"):
            d = json.loads(f.read_text())
            d.update((upd or {}).get(d.get("kind"), {}) if kind == "traffic"
                     else upd or {})
            f.write_text(json.dumps(d))
    return dest


# small CPU sizes of the traffic kinds: the widths stay, the batch shrinks
SMALL = {"predict_closed": {"batch": 4, "pool": 3, "traced_requests": 2},
         "train_steps": {"batch": 8, "pool": 3, "traced_rounds": 1}}
